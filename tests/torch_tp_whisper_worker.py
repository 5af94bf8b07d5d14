"""Worker processes for ``test_torch_tp_whisper.py``,
``test_torch_tp_whisper_fsdp.py`` and ``test_torch_tp_whisper_reference.py``:
whisper (the encoder-decoder) over a "model" mesh axis above 1 on a gloo mesh
of CPU processes, against the port in one process and, where the parent
hands over the reference's results, against the JAX reference on one
device. Imports neither JAX nor a test file, so that spawned workers start
fast.

The configs (``config``), float32:

* ``whisper-base``: whisper-reduced (d_model 64, 4 heads, d_ff 128, vocab
  256, 2 + 2 layers). Over 2 ranks its heads, ffn and vocab split
  (head-parallel attention, column- then row-parallel MLP, vocab-parallel
  embedding, logits and CE); over 3 nothing splits;
* ``whisper-prod``: the production layout of whisper-base at 16 ranks,
  over 2: d_model 48, 3 heads (whole), d_ff 128 (split), vocab 251 (a
  prime: whole), so attention runs on the rank's rows or all of them and
  the tied logits on the whole table.

Sequences split where they divide the axis and run whole on every rank
where they do not (``transformer.seq_rows``): the train cases
(``TRAIN_CASES``: encoder frames, tokens) and the serve cases
(``SERVE_CASES``: frames, prompt, self-cache slots) cover each pair of
split and whole encoder and decoder rows, and each cache layout
(``whisper.cache_layout``: slots, kv heads, whole).

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir``, builds the mesh
(data, model) = ``shape`` and, for each config of ``CASES[shape]``, checks

* the init: the rank's shards the same slices of the one-process draw,
  bit for bit (``torch_tp_attn_worker.check_init``);
* each train case: one ``build_train_step`` step (AdamW, clip 1, two
  microbatches; fsdp on (2, 2)) against the one-process step by the dense
  tensor-parallel bounds (``torch_tp_attn_worker.check_train``: metrics
  and gradients by the float32 noise rule, each gradient leaf within
  GRAD_LEAF_TOL of its own largest, the parameters within 1e-5 plus a
  share of the learning rate), the logits left in float32
  (``float32_logits``: the bf16 rounding of two float32 runs' logits
  flips apart where their sums' orders differ);
* each serve case: ``build_prefill_step`` and 8 ``build_decode_step``
  steps against the one-process model: logits within 1e-5 of max(1,
  |value|) or one bf16 ulp where two float32 products round apart
  (counted), the caches gathered by their layouts by the float32 noise
  rule against the one-process run with float64 weights.

With ``ref_path`` (a data axis of 1): the reference's float32 params in the
rank's shards; the loss and its gradients (the mesh's: split leaves
gathered, the others summed over "model" as the train step sums them)
against the reference's in float64 by ``test_torch_train_whisper.py``'s
rule (the loss with the one-process port's own gap to it added as a
witness: its float32 logits and the reference's round a few bf16 logits
apart, 4.4e-5 of the loss on whisper-reduced's batch here against the
reference's own 9.5e-7), and the prefill's and decode steps' logits by
``test_torch_whisper.py``'s. It writes its largest gaps to
``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import whisper as W
from repro_torch.models.convert import load_jax_params
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten

import torch_tp_attn_worker as aw
import torch_tp_worker as tw

B, STEPS = tw.B, tw.STEPS
CASES = {(1, 2): ("whisper-base", "whisper-prod"), (1, 3): ("whisper-base",),
         (2, 2): ("whisper-base", "whisper-prod")}
REF_CASES = {(1, 2): ("whisper-base", "whisper-prod"), (1, 3): ("whisper-base",)}
# (encoder frames, tokens) by model axis: both split, both whole, and mixed
TRAIN_CASES = {2: ((12, 12), (9, 9), (9, 12), (12, 9)), 3: ((12, 12), (10, 10))}
# (encoder frames, prompt, self-cache slots) by model axis
SERVE_CASES = {2: ((10, 6, 24), (9, 5, 25), (9, 5, 24), (10, 6, 25)),
               3: ((12, 6, 24), (10, 5, 25))}
REF_TRAIN = {2: (10, 12), 3: (10, 12)}
REF_SERVE = {2: (9, 6, 24), 3: (12, 5, 25)}
POS_DEC_TOL = 2.0 ** -7          # two bf16 ulps of pos_dec's largest gradient
# AdamW's first step at a noise gradient (below GRAD_LEAF_TOL of its leaf's
# largest), of the learning rate: it moves such an element by up to lr in
# its noise's direction, and whisper-reduced's gain leaves two float32 runs'
# noise there on either side (measured on (2, 2): an element of
# enc[0].attn.wk's gradient 2.3e-8 in float64, 2.5e-10 in one process and
# -4.0e-9 on the mesh, which AdamW's first step then moved 1.49 lr apart)
NOISE_LR = 2.0
REF_LOSS_FLOOR = 1e-5            # beside the reference's own float32 gap: test_torch_train_whisper
REF_GRAD_FLOOR = 2e-3            # of a leaf's largest float64 |gradient|, beside its own gap


def config(name: str, get=get_config):
    """whisper-reduced, or its production-layout copy (the module
    docstring); ``get`` is a package's ``get_config`` (the reference's
    takes the same edits)."""
    import dataclasses

    cfg = get("whisper-base", reduced=True)
    if name == "whisper-prod":
        cfg = dataclasses.replace(cfg, name="whisper-prod", vocab=251, d_model=48, n_heads=3,
                                  kv_heads=3, d_ff=128)
    return cfg


def step_config(shape):
    return psh.IplsStepConfig(grad_clip=1.0, accum_steps=2, fsdp=shape[0] > 1)


def frames(cfg, S, seed):
    """(B, S, d_model) float32 frame embeddings from a numpy seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


class float32_logits:
    """whisper's training without its two bf16 roundings: the tied logits
    (``whisper._tied_logits``) and ``pos_dec``'s rows before their add
    (``whisper._pos_bf16``) left in float32. Two float32 runs' sums in other
    orders put some of those roundings (the logits', and the gradient's of
    ``pos_dec`` that its cast's backward rounds) on two sides of a bf16
    boundary, which moves the gradient norm past the float32 noise rule
    (measured on (2, 2): 8.2e-5 of it against a bound of 5.1e-5)."""

    def __enter__(self):
        self.saved = W._tied_logits, W._pos_bf16
        W._tied_logits = lambda x, table: x @ table.t()
        W._pos_bf16 = lambda rows: rows

    def __exit__(self, *exc):
        W._tied_logits, W._pos_bf16 = self.saved


def _one_loss(model, D):
    return model.loss


def check_train(name, mesh, gaps, shape):
    cfg = config(name)
    M = psh.mesh_axis_size(mesh, "model")
    for S_enc, S in TRAIN_CASES[M]:
        batch = {"tokens": tw._tokens(cfg.vocab, 1, (B, S)), "participation": torch.ones(B),
                 "enc_embeds": frames(cfg, S_enc, 2)}
        with float32_logits():
            aw.check_train(name, mesh, gaps, cfg=cfg, step_cfg=step_config(shape),
                           key=f"{name}/train_enc{S_enc}_tok{S}", batch=batch,
                           one_loss=_one_loss, leaf_tol=_leaf_tol, noise_lr=NOISE_LR)


def _leaf_tol(leaf: str):
    """The per-leaf gradient bound: none for the key biases (a bias on k
    adds q . bk to every key's score alike, which the softmax cancels: their
    exact gradient is 0, ``test_torch_train_whisper.py``); POS_DEC_TOL for
    ``pos_dec``, whose gradient the bf16 cast before its add rounds to bf16
    in each microbatch, one ulp apart where two runs' float32 sums straddle
    a boundary; GRAD_LEAF_TOL for the others."""
    if leaf.endswith("['bk'].m"):
        return None
    return POS_DEC_TOL if leaf.startswith(".opt_state['pos_dec']") or "pos_dec" in leaf \
        else tw.GRAD_LEAF_TOL


def _gather_entry(entry, layouts, mesh):
    """A rank's cache entry whole over "model", by its leaves' layouts."""
    out = {}
    for k, t in entry.items():
        layout = layouts[0] if k in ("k", "v") else layouts[1]
        spec = {"slots": (None, "model", None, None), "heads": (None, None, "model", None),
                "whole": ()}[layout]
        out[k] = psh.gather(t, spec, mesh, ("model",))
    return out


def _whole_cache(cache, cfg, mesh, cache_len, enc_len):
    M = psh.mesh_axis_size(mesh, "model")
    layouts = (W.cache_layout(cache_len, cfg.kv_heads, M), W.cache_layout(enc_len, cfg.kv_heads, M))
    return [_gather_entry(e, layouts, mesh) for e in cache["dec"]], layouts


def check_serve(name, mesh, gaps):
    cfg = config(name)
    M = psh.mesh_axis_size(mesh, "model")
    one = build_model(cfg, device="cpu", seed=0).float()
    one64 = build_model(cfg, device="cpu", seed=0).double()
    tp = build_model(cfg, device="cpu", seed=0, mesh=mesh).float()
    rows = tw._rows(mesh)
    for S_enc, P, T in SERVE_CASES[M]:
        key = f"{name}/enc{S_enc}_p{P}_t{T}"
        tokens = tw._tokens(cfg.vocab, 2, (B, P))
        enc = frames(cfg, S_enc, 3)
        pre = build_prefill_step(tp, mesh, ShapeSpec("p", P, B, "prefill"))
        logits, cache = pre.fn({"tokens": tokens, "enc_embeds": enc, "cache_len": T})
        one_logits, one_cache = one.prefill({"tokens": tokens[rows], "enc_embeds": enc[rows],
                                             "cache_len": T})
        with tw._Float64Attention():
            _, cache64 = one64.prefill({"tokens": tokens[rows], "enc_embeds": enc[rows].double(),
                                        "cache_len": T})
        tw._logit_gap(logits, one_logits, gaps, f"{key}/prefill_logits")
        whole, layouts = _whole_cache(cache, cfg, mesh, T, S_enc)
        gaps[f"{name}/layout_self_{layouts[0]}_cross_{layouts[1]}"] = 1
        for a, b, c in zip(tree_leaves(whole), tree_leaves(one_cache["dec"]),
                           tree_leaves(cache64["dec"])):
            tw._noise_bound(a, b, c, gaps, f"{name}/prefill_cache")
        dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
        steps = tw._tokens(cfg.vocab, 3, (STEPS, B, 1))
        for t in range(STEPS):
            logits, cache = dec.fn(cache, {"token": steps[t], "pos": P + t, "enc_len": S_enc})
            one_logits, one_cache = one.decode_step(one_cache, {"token": steps[t][rows],
                                                                "pos": P + t})
            with tw._Float64Attention():
                one64.decode_step(cache64, {"token": steps[t][rows], "pos": P + t})
            tw._logit_gap(logits, one_logits, gaps, f"{name}/decode_logits")
        whole, _ = _whole_cache(cache, cfg, mesh, T, S_enc)
        for a, b, c in zip(tree_leaves(whole), tree_leaves(one_cache["dec"]),
                           tree_leaves(cache64["dec"])):
            tw._noise_bound(a, b, c, gaps, f"{name}/decode_cache")


def mesh_loss_and_grads(model, mesh, batch):
    """The loss on the mesh (under the train step's context) and its
    gradients, whole: split leaves gathered over "model", the others summed
    over it, as the train step's plane sums them."""
    rules = dict(psh.DEFAULT_RULES, **make_rules(mesh, "train"))
    params = model.params()
    alias = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with activation_sharding(mesh, rules):
        per_ex, _ = model.loss(tree_unflatten(params, alias), batch)
        grads = torch.autograd.grad(per_ex.mean(), alias)

    def whole(g, spec):
        if psh._splits_over(spec, "model"):
            return psh.gather(g, spec, mesh, ("model",))
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.get_group("model"))
        return g

    return per_ex.detach(), psh.map_specs(whole, tree_unflatten(params, list(grads)),
                                          model.param_specs)


def check_reference(name, mesh, ref, gaps):
    """The reference's params in the rank's shards: the loss and its
    gradients, the prefill's and decode steps' logits, against the
    reference run in float64 (the module docstring)."""
    from repro_torch.core.sharded import IplsTrainState
    from repro_torch.models.convert import to_reference_layout

    r = ref[name]
    cfg = config(name)
    tp = load_jax_params(build_model(cfg, device="cpu", seed=0, mesh=mesh).float(), r["params"])
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    per_ex, grads = mesh_loss_and_grads(tp, mesh, batch)
    own = np.abs(r["loss32"] - r["loss64"]).max()
    # the witness: the port's loss in one process on the same params (its
    # float32 logits round some bf16 logits apart from the reference's)
    one = load_jax_params(build_model(cfg, device="cpu", seed=0).float(), r["params"])
    with torch.no_grad():
        one_loss = one.loss(one.params(), batch)[0].double().numpy()
    witness = np.abs(one_loss - r["loss64"]).max()
    gaps[f"{name}/ref_loss_one_process_gap"] = float(witness)
    tw._note(gaps, f"{name}/ref_loss_of_bound",
             float(np.abs(per_ex.double().numpy() - r["loss64"]).max())
             / (own + witness + REF_LOSS_FLOOR), 1.0)
    state = IplsTrainState(torch.zeros(()), grads, (), torch.zeros(()))
    got = {k: v.double().numpy() for k, v in named_leaves(to_reference_layout(state).params)}
    for leaf, w64 in r["grads64"].items():
        d = np.abs(got[leaf] - w64).max()
        own = np.abs(r["grads32"][leaf] - w64).max()
        if leaf.endswith("['bk']"):  # exact gradient 0: float noise alone
            tw._note(gaps, f"{name}/ref_bk_grad_noise_of_own", d / max(2.0 * own, 1e-12), 1.0)
            continue
        bound = own + REF_GRAD_FLOOR * max(np.abs(w64).max(), 1e-30)
        tw._note(gaps, f"{name}/ref_grads_of_bound", float(d / bound), 1.0)
    S_enc, P, T = r["serve"]
    serve = {"tokens": torch.from_numpy(r["serve_tokens"]),
             "enc_embeds": torch.from_numpy(r["serve_frames"]), "cache_len": T}
    pre = build_prefill_step(tp, mesh, ShapeSpec("p", P, B, "prefill"))
    logits, cache = pre.fn(serve)
    got_l = [logits]
    dec = build_decode_step(tp, mesh, ShapeSpec("d", T, B, "decode"))
    for t in range(STEPS):
        logits, cache = dec.fn(cache, {"token": torch.from_numpy(r["steps"][t]), "pos": P + t,
                                       "enc_len": S_enc})
        got_l.append(logits)
    for i, g in enumerate(got_l):
        w32, w64 = r["logits32"][i], r["logits64"][i]
        bound = np.abs(w32 - w64).max() + float(tw._ulp_bf16(torch.tensor(np.abs(w64).max())))
        tw._note(gaps, f"{name}/ref_logits_of_bound",
                 float(np.abs(g.double().numpy() - w64).max()) / bound, 1.0)


def run(rank, world, shape, out_dir, ref_path=None):
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
            for name in REF_CASES[shape]:
                check_reference(name, mesh, {name: ref[f"{name}/M{shape[1]}"]}, gaps)
        else:
            for name in CASES[shape]:
                aw.check_init(name, mesh, gaps, cfg=config(name))
                check_train(name, mesh, gaps, shape)
                check_serve(name, mesh, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
