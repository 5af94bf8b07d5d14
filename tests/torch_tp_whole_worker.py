"""Worker processes for ``test_torch_tp_whole*.py``: prompts and caches that
do not divide the "model" mesh axis, in the decoder-only families, on gloo
meshes of CPU processes, against the port in one process and, where the
parent hands over the reference's results, against the JAX reference on one
device. The reference's specs leave such a dim replicated: the sequence is
whole on every rank (``transformer._tp_ctx``: no rows), each cache leaf
takes the layout its spec gives (``sharding_hooks.cache_layout``: slots,
kv heads, or whole), and decode runs each layer in its own cache's layout.
Imports neither JAX nor a test file, so that spawned workers start fast.

The jobs (``JOBS``; one spawn per job and mesh), float32, B = 4:

* ``dense`` on (1, 3), prompt 10, cache 14 (neither divides 3):
  internlm2-, qwen2-vl- (M-RoPE, positions3 that are not the token
  positions) and gemma3-reduced (8-slot rings, whole too): 4 heads, d_ff
  128 and vocab 256 do not divide 3, so every block runs alike on every
  rank and counts its leaves once in the gradients; ``dense-straddle``
  (6 heads over 2 kv heads, d_ff 96): head-parallel, 2 query heads a rank,
  rank 1's straddling kv heads 0 and 1 of the whole cache (one decode call
  per kv head), the MLP column- then row-parallel on whole rows. On (1, 4),
  prompt 10, cache 14: internlm2- and phi4-mini-reduced (tied), 4 heads
  over 2 kv heads: one query head a rank over kv head r // 2 of the whole
  cache; ffn and vocab split (vocab-parallel CE on whole rows);
* ``fsdp`` on (2, 2) with fsdp, prompt 9, cache 13: internlm2-,
  qwen2-vl- and gemma3-reduced, head-parallel on whole rows (inputs by
  ``to_parts``, parts all-reduced in float32); gemma3's 8-slot rings split
  over the ranks' slots beside full caches of 13 whole: a mixed layout;
* ``moe`` on (1, 3) and (2, 2) as above: granite- and deepseek-reduced
  (MLA, its latent cache whole; the MoE replicated on (1, 3), ffn- or
  expert-parallel on (2, 2));
* ``ssm`` on (1, 3) and (2, 2) as above: zamba2-reduced (Mamba2 and its
  shared blocks) and RWKV6 (rwkv6-reduced on (1, 3), ``rwkv6-heads4`` on
  (2, 2): 2 heads a rank, the output's columns gathered), the train check
  twice as ``torch_tp_ssm_worker`` runs it (float32 logits, then bf16
  with the logit gradients' measured flips as a floor).

Each case holds ``torch_tp_attn_worker``'s checks with their bounds (the
dense tensor-parallel tests' float32 noise rule): the init, one
train step (AdamW, clipping at 1, two microbatches but one for M-RoPE) to
the one-process step (metrics, gradients, parameters after AdamW's first
step), the prefill's logits and caches and 3 decode steps. On (1, 3) the
``dense`` job also checks that the train check fails where the leaves
every rank computes alike count on every rank (``once_whole`` made the
identity): the gradients would be 3 times too large.

With ``ref_path`` (on (1, 3)): the reference's params in the rank's shards
(here every leaf whole), its train step, prefill and decode logits against
the mesh's (``torch_tp_attn_worker.check_reference``'s bounds, but
REF_NOISE_LR for the elements of noise gradients). It writes its largest
gaps to ``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import json
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import dense_lm
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding_hooks as SH

import torch_tp_attn_worker as aw
import torch_tp_ssm_worker as sw
import torch_tp_worker as tw

B, S, T, STEPS = 4, 10, 14, 3        # (1, 3) and (1, 4): neither S nor T divides the axis
SEQ = {(1, 3): (S, T), (1, 4): (S, T), (2, 2): (9, 13)}
LR = aw.LR
ATTN = ("internlm2-1.8b", "qwen2-vl-72b", "gemma3-1b")
JOBS = {
    "dense": {(1, 3): ATTN + ("dense-straddle",), (1, 4): ("internlm2-1.8b", "phi4-mini-3.8b")},
    "fsdp": {(2, 2): ATTN},
    "moe": {(1, 3): ("granite-moe-3b-a800m", "deepseek-v2-lite-16b"),
            (2, 2): ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")},
    "ssm": {(1, 3): ("zamba2-1.2b", "rwkv6-7b"), (2, 2): ("zamba2-1.2b", "rwkv6-heads4")},
}
REF_CASES = ATTN  # on (1, 3)
# AdamW's first step at a noise gradient, against the reference: each run
# moves such an element by up to lr in the direction of its noise's sign,
# so two runs lie up to 2 lr apart (ROADMAP.md queue 3: qwen2-vl-reduced's
# lm_head at a prompt of 10, gradients 1.4e-9 and -2.1e-9 of a leaf whose
# largest is 7.5e-4, 1.24 lr apart, the one-process port as far as the mesh)
REF_NOISE_LR = 2.0
RECURRENT = ("zamba2", "rwkv6")


def config(name: str, lossless: bool = False, get=get_config):
    """A reduced config by name (the module docstring); ``get`` is the
    package's ``get_config`` (the reference's takes the same edits)."""
    if name == "dense-straddle":
        return dense_lm("dense-straddle", n_layers=2, d_model=64, n_heads=6, kv_heads=2,
                        d_ff=96, vocab=256, head_dim=16)
    if name.startswith(RECURRENT):
        return sw.config(name, get)
    return aw.config(name, lossless, get)


def accum_steps(cfg) -> int:
    return aw.accum_steps(cfg)


def step_config(name: str, shape=(1, 3)):
    """Clipping at 1, two microbatches (one for M-RoPE); fsdp on a data axis
    above 1, else the arch's ``TRAIN_OVERRIDES``."""
    if shape[0] > 1:
        return psh.IplsStepConfig(grad_clip=1.0, accum_steps=accum_steps(config(name)),
                                  fsdp=True)
    if name in ("dense-straddle",) or name.startswith(RECURRENT):
        return psh.IplsStepConfig(grad_clip=1.0, accum_steps=2)
    return aw.step_config(name)


def train_batch(cfg, tokens, mask=None):
    return aw.train_batch(cfg, tokens, mask)


def serve_batch(cfg, tokens, rows=slice(None)):
    return aw.serve_batch(cfg, tokens, rows, T=T)


def check_train(name, mesh, gaps, shape):
    """One train step on a prompt of the mesh's S tokens against one
    process: for the recurrent families twice (``torch_tp_ssm_worker``)."""
    cfg, (n, _) = config(name), SEQ[shape]
    kw = dict(cfg=cfg, step_cfg=step_config(name, shape),
              batch=train_batch(cfg, tw._tokens(256, 1, (B, n))))
    if not name.startswith(RECURRENT):
        aw.check_train(name, mesh, gaps, **kw)
        return
    with sw.float32_logits():
        aw.check_train(name, mesh, gaps, **kw)
    aw.check_train(name, mesh, gaps, flips=sw.LogitGradients(),
                   key=f"{name}/train_bf16_logits", **kw)


def check_case(name, mesh, gaps, shape):
    cfg = config(name)
    aw.check_init(name, mesh, gaps, cfg=cfg)
    check_train(name, mesh, gaps, shape)
    n, slots = SEQ[shape]
    aw.check_serve(name, mesh, gaps, cfg=cfg, S=n, T=slots, n_steps=STEPS,
                   float64_logits=name.startswith("zamba2"))


def check_counted_once(mesh, gaps):
    """The train check fails where the leaves that every rank computes
    alike count on every rank (``SH.once_whole`` the identity)."""
    saved = SH.once_whole
    SH.once_whole = lambda tree, defs, tp: tree
    try:
        gaps["internlm2-1.8b/counted_on_every_rank_fails"] = int(sw._fails(
            check_train, "internlm2-1.8b", mesh, {}, (1, 3)))
    finally:
        SH.once_whole = saved


def run(rank, world, shape, out_dir, job, ref_path=None):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        shape = tuple(shape)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        gaps: dict = {}
        if ref_path is not None:
            with open(ref_path, "rb") as f:
                ref = pickle.load(f)
            for name in REF_CASES:
                if name in ref:
                    aw.check_reference(name, mesh, ref, gaps, cfg=config(name, lossless=True),
                                       step_cfg=step_config(name), S=S, T=T, n_steps=STEPS,
                                       noise_lr=REF_NOISE_LR)
        else:
            for name in JOBS[job][shape]:
                check_case(name, mesh, gaps, shape)
            if job == "dense" and shape == (1, 3):
                check_counted_once(mesh, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
