"""The MoE family's training under a mesh context, on the CPU.

A built train step runs the model under the step's sharding context
(``sharding_hooks.activation_sharding``), where an MoE layer takes the
reference's mesh path (one group, capacity from the rank's tokens) and
outside it the grouped path. On a card the autograd engine runs the
backward, and with it each checkpointed layer's recompute, on its own
device thread, where that context (a ContextVar) is unset: before
``sharding_hooks.remat_context`` the recompute took the grouped path after
a forward on the mesh path, and granite-moe's built step failed on the
card (the recomputed tensors' shapes differ). Here the backward runs on
another thread, as on a card: its gradients equal, bit for bit, those of
the same loss without remat (nothing recomputed), and the recompute no
longer raises. No JAX here: the MoE layer against the reference is
``tests/test_torch_moe.py`` and ``test_torch_moe_lm.py``.
"""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import build_model, get_config
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.sharding_hooks import activation_sharding
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "granite-moe-3b-a800m"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small products: run torch on one thread (no numeric effect:
    both sides of every comparison run in this process), and give the pool
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def smoke_group():
    """The smoke mesh's one-process group, destroyed after the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _grads(remat: bool, other_thread: bool):
    """The gradients of the loss's sum: the forward under the smoke mesh's
    sharding context, the backward on this thread inside it, or on another
    thread (outside it, as a card's autograd thread is)."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), remat=remat)
    model = build_model(cfg, device="cpu", seed=0).float()
    params = model.params()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tokens = torch.arange(2 * 24, dtype=torch.int32).reshape(2, 24) % cfg.vocab
    out = {}
    with activation_sharding(make_smoke_mesh("cpu")):
        per_ex, _ = model.loss(tree_unflatten(params, leaves), {"tokens": tokens})
        if not other_thread:
            out["grads"] = torch.autograd.grad(per_ex.sum(), leaves)
    if other_thread:
        def backward():
            try:
                out["grads"] = torch.autograd.grad(per_ex.sum(), leaves)
            except Exception as e:  # noqa: BLE001 - reported to the test's thread
                out["error"] = e

        t = threading.Thread(target=backward)
        t.start()
        t.join()
        if "error" in out:
            raise out["error"]
    return out["grads"]


def test_checkpoint_recompute_runs_under_the_forward_sharding_context():
    want = _grads(remat=False, other_thread=False)
    for other_thread in (False, True):
        got = _grads(remat=True, other_thread=other_thread)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), other_thread
