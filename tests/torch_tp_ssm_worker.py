"""Worker processes for ``test_torch_tp_ssm.py`` and
``test_torch_tp_ssm_reference.py``: the recurrent families over a "model"
mesh axis above 1 (zamba2's Mamba2 blocks with its shared attention and MLP
blocks; RWKV6's time and channel mix) on a gloo mesh of CPU processes,
against the port in one process and, where the parent hands over the
reference's results, against the JAX reference on one device. Imports
neither JAX nor a test file, so that spawned workers start fast.

The configs (``config``), float32:

* ``zamba2-1.2b``: zamba2-reduced, 2 Mamba2 heads of 64 (d_inner 128, an
  in-projection of N = 290 columns); over 2 ranks one head a rank, its
  ``w_in`` split into 145 columns that hold no whole head (gathered);
  over 3 nothing splits and every rank runs the block whole. Its shared
  attention (4 heads) and MLP (d_ff 128) take the dense paths;
* ``zamba2-heads8``: the same with Mamba2 heads of 16 (8 heads, N = 296):
  4 heads a rank over 2;
* ``zamba2-head128``: one Mamba2 head of 128 (N = 289, whole on every
  rank): over 2 ranks the head does not split but ``w_out``'s rows do,
  so every rank runs the block whole and its rows of ``w_out`` take its
  columns of the norm's output (a partial sum);
* ``rwkv6-7b``: rwkv6-reduced, one head of 64: over 2 ranks its columns
  split in halves (the leaves gathered whole, the block run whole); the
  channel mix's d_ff of 128 splits (a partial sum reduce-scattered);
* ``rwkv6-heads4``: heads of 16 (4 heads; the CPU path takes any head
  size): 2 heads a rank over 2 (the scan wrapper on the rank's heads, the
  norm's squares summed, the output's columns laid out as rows by an
  all-to-all).

``run(rank, world, shape, out_dir, ref_path)`` is the spawn entry: each rank
joins a gloo group through a file store in ``out_dir``, builds the mesh
(data, model) = ``shape`` and, for each config of ``CASES[shape]``, runs
``torch_tp_attn_worker``'s checks with their bounds (the dense
tensor-parallel tests' bounds and float32 noise rule): the init (the
rank's shards the same slices of the one-process draw, bit for bit; the
count of split leaves), one train step (AdamW, clipping at 1, two
microbatches; with fsdp on (2, 2)) against the one-process step, twice:
with the logits left in float32 (``float32_logits``), by the noise rule
alone, and with the bf16 logits the model ships, the gradients' noise
floored by the measured difference of the two runs' bf16 gradients in
the logits (``LogitGradients``), a prefill
and 8 decode steps against the one-process model (logits, and the caches
gathered over "model": Mamba2's state split by heads, its convolution
history whole; RWKV6's state by heads, ``x_prev`` whole; the shared
attention's caches over their slots). On (1, 2) zamba2-reduced's
reference-layout tree goes into the shards and back, and a checkpoint
saved on the mesh equals one process's save, each way, bit for bit
(``torch_tp_worker.check_convert_and_checkpoint``), and two mutations of
the mesh path must fail the checks above (``check_wrong_collectives``):

* RWKV6's output projection taken as a row-parallel product whose partial
  sums are reduce-scattered (``scatter_seq``), as attention's and the
  MLP's are, in place of the columns-to-rows all-to-all: the prefill's
  logits fail;
* Mamba2's ``w_in`` gathered without its gradient's reduce-scatter (each
  rank keeping its own partial gradient of the whole weight): the train
  step's gradients fail, with float32 logits and with bf16 ones.

With ``ref_path`` (a data axis of 1): the reference's params in the rank's
shards, its train step, prefill and decode logits against the mesh's
(``torch_tp_attn_worker.check_reference``'s bounds). It writes its
largest gaps to ``out_dir/rank{r}.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding_hooks as SH
from repro_torch.models import ssm
from repro_torch.models.transformer import TransformerLM

import torch_tp_attn_worker as aw
import torch_tp_worker as tw

ZAMBA2 = ("zamba2-1.2b", "zamba2-heads8", "zamba2-head128")
RWKV6 = ("rwkv6-7b", "rwkv6-heads4")
CASES = {(1, 2): ZAMBA2 + RWKV6, (2, 2): ZAMBA2[:2] + RWKV6, (1, 3): ("zamba2-1.2b",) + RWKV6}
REF_CASES = {(1, 2): ("zamba2-1.2b", "rwkv6-7b", "rwkv6-heads4"),
             (1, 3): ("zamba2-1.2b", "rwkv6-7b")}


def _map_blocks(cfg, fn):
    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, blocks=tuple(fn(b) for b in g.blocks)) for g in cfg.groups))


def config(name: str, get=get_config):
    """A reduced config by name (the module docstring); ``get`` is the
    package's ``get_config`` (the reference's takes the same edits)."""
    arch = "zamba2-1.2b" if name.startswith("zamba2") else "rwkv6-7b"
    cfg = get(arch, reduced=True)
    head = {"zamba2-heads8": 16, "zamba2-head128": 128, "rwkv6-heads4": 16}.get(name)
    if head is None:
        return cfg
    if arch == "zamba2-1.2b":
        cfg = _map_blocks(cfg, lambda b: dataclasses.replace(
            b, mamba=dataclasses.replace(b.mamba, head_dim=head)))
    else:
        cfg = _map_blocks(cfg, lambda b: dataclasses.replace(
            b, rwkv=dataclasses.replace(b.rwkv, head_dim=head)))
    return dataclasses.replace(cfg, name=name)


def step_config(shape):
    """Two microbatches; fsdp on a data axis above 1."""
    return psh.IplsStepConfig(grad_clip=1.0, accum_steps=2, fsdp=shape[0] > 1)


class float32_logits:
    """The models' logits left in float32 (not rounded to bfloat16), for
    the first of the two train checks: there the gradients are held by the
    float32 noise rule alone. The second runs the model as it ships
    (bfloat16 logits) with ``LogitGradients``."""

    def __enter__(self):
        self.saved = TransformerLM._logits

        def logits(model, x, params=None):
            key = model._head_key()
            table = getattr(model, key).table if params is None else params[key]["table"]
            return x @ table.t()

        TransformerLM._logits = logits

    def __exit__(self, *exc):
        TransformerLM._logits = self.saved


class LogitGradients:
    """The gradient of a train step's loss in the models' bf16 logits (the
    ``_logits`` output), recorded in forward order on the mesh
    (``recording("mesh")``) and in one process (``recording("one")``).
    The cast's backward rounds it to bf16: where the two float32 runs'
    cross entropies (summed in other orders over the vocab's split) put an
    element on two sides of a bf16 boundary, the two gradients differ there
    by one bf16 ulp, and the parameters' gradients, linear in it, move with
    it (on rwkv6-reduced over 2 ranks, 2 such elements of 11,264 move them
    by 4e-5 of the largest, 20 times the float32 noise). ``share`` is that
    difference summed over the batch (all-reduced over the mesh) over the
    largest |gradient|: the train check takes it as a floor of the
    gradients' noise. The elements that differ at all are at most
    FLIP_FRACTION of them (their pairing of the mesh's pieces to the one
    process's calls is checked by it)."""

    FLIP_FRACTION = 0.01

    def __init__(self):
        self.grads = {"mesh": [], "one": []}

    @contextlib.contextmanager
    def recording(self, side):
        saved, slots = TransformerLM._logits, self.grads[side]

        def logits(model, x, params=None):
            out = saved(model, x, params)
            if out.requires_grad:
                i = len(slots)
                slots.append(None)
                out.register_hook(lambda g, i=i: slots.__setitem__(i, g.detach().double()))
            return out

        TransformerLM._logits = logits
        try:
            yield
        finally:
            TransformerLM._logits = saved

    def share(self, mesh) -> float:
        """|mesh - one|_1 over the whole batch / max |one|. Data rank d's
        microbatch j is the one process's call d A + j (its rows, as
        ``torch_fsdp_worker.emulated_loss`` takes them); a model rank holds
        its columns of the vocab where the table is split, else its rows of
        the sequence (all of them where the sequence does not split)."""
        D = psh.mesh_axis_size(mesh, "data")
        M = psh.mesh_axis_size(mesh, "model")
        d, r = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        got, want = self.grads["mesh"], self.grads["one"]
        A = len(got)
        assert A and len(want) == A * D and all(g is not None for g in got + want)
        acc = torch.zeros(3, dtype=torch.float64)  # |d|_1, elements that differ, elements
        top = torch.zeros(1, dtype=torch.float64)
        for j, g in enumerate(got):
            w = want[d * A + j]
            if g.shape[-1] < w.shape[-1]:
                w = w[..., r * g.shape[-1]:(r + 1) * g.shape[-1]]
            elif g.shape[1] < w.shape[1]:
                lo = r * ((w.shape[1] + 1) // M)
                w = w[:, lo:lo + g.shape[1]]
            assert g.shape == w.shape, (g.shape, w.shape)
            diff = (g - w).abs()
            acc += torch.tensor([float(diff.sum()), float((diff > 0).sum()), diff.numel()],
                                dtype=torch.float64)
            top = torch.maximum(top, w.abs().max().reshape(1))
        dist.all_reduce(acc)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        assert acc[1] <= self.FLIP_FRACTION * acc[2], acc.tolist()
        return float(acc[0] / top[0])


def _fails(check, *args, **kw) -> bool:
    try:
        check(*args, **kw)
    except AssertionError:
        return True
    return False


def _row_parallel_out(params, yg, ss, width):
    """The wrong output of RWKV6's time mix: ``wo``'s rows as a row-parallel
    product (a partial sum of every column)."""
    return ssm.rms_norm_parts(params["ln_out"]["scale"], yg, ss, width) @ params["wo"]


class _GatherWithoutGradSum(torch.autograd.Function):
    """A split leaf gathered whole, its gradient left on each rank as the
    rank's slice of its own partial gradient (no reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, t.shape[dim]
        return SH.gather_model(t, tp, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None, None


def _whole_without_grad_sum(t, dim, full, tp):
    """The wrong ``ssm._whole``."""
    return t if t.shape[dim] == full else _GatherWithoutGradSum.apply(t, dim, tp)


def check_wrong_collectives(mesh, gaps):
    """The mutations of the module docstring fail the checks."""
    saved = ssm.rwkv6_time_out, SH.cols_to_rows
    ssm.rwkv6_time_out, SH.cols_to_rows = _row_parallel_out, SH.scatter_seq
    try:
        gaps["rwkv6-heads4/row_parallel_output_fails"] = int(_fails(
            aw.check_serve, "rwkv6-heads4", mesh, {}, cfg=config("rwkv6-heads4")))
    finally:
        ssm.rwkv6_time_out, SH.cols_to_rows = saved
    saved = ssm._whole
    ssm._whole = _whole_without_grad_sum
    try:
        for logits in ("float32", "bf16"):
            gaps[f"zamba2-1.2b/w_in_gather_without_grad_sum_fails_{logits}_logits"] = int(_fails(
                check_train, "zamba2-1.2b", mesh, {}, (1, 2), logits))
    finally:
        ssm._whole = saved


def check_train(name, mesh, gaps, shape, logits):
    """The train check with the logits in float32 (``float32_logits``: the
    float32 noise rule alone) or bf16, as the model ships
    (``LogitGradients``' floor)."""
    kw = dict(cfg=config(name), step_cfg=step_config(shape))
    if logits == "float32":
        with float32_logits():
            aw.check_train(name, mesh, gaps, **kw)
    else:
        aw.check_train(name, mesh, gaps, flips=LogitGradients(),
                       key=f"{name}/train_bf16_logits", **kw)


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
                if name in ref:
                    aw.check_reference(name, mesh, ref, gaps, cfg=config(name),
                                       step_cfg=step_config(shape))
        else:
            for name in CASES[shape]:
                cfg = config(name)
                aw.check_init(name, mesh, gaps, cfg=cfg)
                for logits in ("float32", "bf16"):
                    check_train(name, mesh, gaps, shape, logits)
                aw.check_serve(name, mesh, gaps, cfg=cfg)
            if shape == (1, 2):
                check_wrong_collectives(mesh, gaps)
                tw.check_convert_and_checkpoint("zamba2-1.2b", mesh, out_dir, gaps)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()
