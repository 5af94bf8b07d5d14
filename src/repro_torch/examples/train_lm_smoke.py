"""End-to-end driver: train a reduced LM for a few hundred steps through the
full production path: model zoo config, the IPLS train step (eps-weighted
reduce-scatter / owned update / all-gather), the sharded optimizer,
checkpoints and restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_smoke --arch internlm2-1.8b --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm_smoke --device cpu --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm_smoke --device cpu --steps 300 --resume

One process on the smoke mesh (data=1, model=1); a checkpoint after every
100 steps under ``--ckpt-dir`` (the last two kept), which ``--resume``
restores, and each step's batch drawn from a seed of its own, so that a
resumed run goes on as the uninterrupted one would. Runs on CUDA unless
``--device cpu``.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core.sharded import IplsStepConfig
from repro_torch.data import synth_tokens
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "ipls_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg, device=args.device, seed=0)
    owns_group = not dist.is_initialized()
    mesh = make_smoke_mesh(args.device)
    try:
        return _train(args, cfg, model, mesh)
    finally:
        if owns_group:  # the one-process group make_smoke_mesh started
            dist.destroy_process_group()


def _train(args, cfg, model, mesh):
    shape = ShapeSpec("smoke_train", seq_len=args.seq, global_batch=args.batch, kind="train")
    opt = adamw(cosine_warmup(3e-3, 20, args.steps), wd=0.01)
    built = build_train_step(model, mesh, shape, optimizer=opt, step_cfg=IplsStepConfig())

    state = built.init_state(model.params())
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume:
        try:
            restored, start = mgr.restore_latest(state)
            with torch.no_grad():  # into the state's own tensors (the model's params)
                for dst, src in zip(tree_leaves(state), tree_leaves(restored)):
                    dst.copy_(src)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    data = synth_tokens(4096, args.seq, min(cfg.vocab, 256), seed=0)
    ones = torch.ones((args.batch,), dtype=torch.float32)
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        sel = np.random.default_rng((0, i)).integers(0, len(data), args.batch)
        batch = {"tokens": torch.from_numpy(data[sel]), "participation": ones}
        state, metrics = built.fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d} loss={losses[-1]:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} eps={float(metrics['eps']):.3f} "
                f"({(time.time() - t0):.1f}s)"
            )
        if (i + 1) % 100 == 0:
            mgr.save_async(state, step=i + 1)  # named by the steps it holds
    mgr.wait()
    print("done; final loss should be well below the ~5.5 random-init level")
    return losses


if __name__ == "__main__":
    main()
