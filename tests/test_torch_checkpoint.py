"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the cases
of the reference's ``tests/test_checkpoint.py``, and checkpoints
interchangeable with the reference's: the tiny train state of
``tests/test_system.py``'s elastic restart written by the reference
restores in the port and the other way round, bit for bit (every array's
dtype, shape and bytes), including bfloat16 leaves and an Adam state; and
the port's elastic restart (stop after step 2, restore, go on) equals the
uninterrupted run bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core import sharded as jsh
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core import sharded as psh
from repro_torch.models.convert import to_torch
from repro_torch.optim import adam, sgd
from repro_torch.tree import named_leaves, tree_map


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread, and give the pool
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
        "step": torch.tensor(7, dtype=torch.int32),
        "eps": torch.tensor(0.5, dtype=torch.float32),
    }


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), t, step=7)
    got, step = restore_checkpoint(str(tmp_path), t)
    assert step == 7
    assert torch.equal(got["params"]["w"], t["params"]["w"])
    assert torch.equal(got["eps"], t["eps"]) and got["step"].dtype == torch.int32


def test_latest_step_ignores_incomplete(tmp_path):
    save_checkpoint(str(tmp_path), tree(), step=3)
    os.makedirs(tmp_path / "step_00000009")  # no COMMITTED marker
    assert latest_step(str(tmp_path)) == 3


def test_shape_mismatch_rejected(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), t, step=1)
    bad = dict(t, params={"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)


def test_manager_keep_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        t["step"].fill_(s)  # in place: save_async must have copied already
        mgr.save_async(t, step=s)
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4]
    got, step = mgr.restore_latest(t)
    assert step == 4 and int(got["step"]) == 4


def test_sharded_checkpoint(tmp_path):
    """Each IPLS partition owner writes only its shard."""
    shard0 = {"w": torch.zeros(4)}
    shard1 = {"w": torch.ones(4)}
    save_checkpoint(str(tmp_path), shard0, step=5, shard_id=0, num_shards=2)
    assert latest_step(str(tmp_path), num_shards=2) is None  # incomplete
    save_checkpoint(str(tmp_path), shard1, step=5, shard_id=1, num_shards=2)
    assert latest_step(str(tmp_path), num_shards=2) == 5
    got0, _ = restore_checkpoint(str(tmp_path), shard0, shard_id=0, num_shards=2)
    got1, _ = restore_checkpoint(str(tmp_path), shard1, shard_id=1, num_shards=2)
    assert torch.equal(got0["w"], shard0["w"]) and torch.equal(got1["w"], shard1["w"])


# -- the tiny state of tests/test_system.py's elastic restart ----------------


def _inputs():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 4)).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 4)).astype(np.float32),
             "y": rng.standard_normal((8, 4)).astype(np.float32)}
    return params, batch


def loss_fn_j(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean(jnp.square(pred - batch["y"]), axis=-1), {}


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    return (pred - batch["y"]).square().mean(dim=-1), {}


def _jax_state(opt, steps=2, extra=False):
    """The reference's state after ``steps`` steps, as numpy arrays; with
    ``extra`` a bfloat16 copy of the params rides along in the params."""
    params, batch = _inputs()
    step = jax.jit(jsh.make_train_step(loss_fn_j, opt, jsh.IplsStepConfig(use_eps=False,
                                                                          grad_clip=None)))
    p = jax.tree.map(jnp.asarray, params)
    if extra:
        p = dict(p, w_bf16=p["w"].astype(jnp.bfloat16))
    s = jsh.init_state(p, opt)
    for _ in range(steps):
        s, _ = step(s, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, s)


def _port_like(ref):
    """An empty port state of the reference state's structure."""
    return psh.IplsTrainState(
        step=torch.zeros((), dtype=torch.int32),
        params={k: torch.empty(v.shape, dtype=to_torch(v).dtype) for k, v in ref.params.items()},
        opt_state=tree_map(lambda a: torch.empty(a.shape), ref.opt_state)
        if ref.opt_state != () else (),
        eps=torch.zeros((), dtype=torch.float32),
    )


def _bits(x):
    """dtype name, shape and bytes of an array or tensor leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_reference_checkpoint_restores_in_port(tmp_path, opt):
    ref = _jax_state(jsgd(0.1) if opt == "sgd" else jadam(1e-2), extra=True)
    JManager(str(tmp_path)).save(ref, step=2)
    got, step = CheckpointManager(str(tmp_path)).restore_latest(_port_like(ref))
    assert step == 2
    want, have = dict(named_leaves(ref)), dict(named_leaves(got))
    assert want.keys() == have.keys() and len(want) == (4 if opt == "sgd" else 8)
    assert all(_bits(want[k]) == _bits(have[k]) for k in want)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_port_checkpoint_restores_in_reference(tmp_path, opt):
    ref = _jax_state(jsgd(0.1) if opt == "sgd" else jadam(1e-2), extra=True)
    port_state = tree_map(to_torch, ref)  # the same bits as port tensors
    CheckpointManager(str(tmp_path)).save(port_state, step=2)
    got, step = JManager(str(tmp_path)).restore_latest(ref)
    assert step == 2
    want, have = dict(named_leaves(port_state)), dict(named_leaves(got))
    assert want.keys() == have.keys()
    assert all(_bits(want[k]) == _bits(have[k]) for k in want)
    # and the reference's own restore functions read every byte
    got2, _ = jrestore(str(tmp_path), ref)
    assert all(_bits(a) == _bits(b) for a, b in zip(jax.tree.leaves(got2), jax.tree.leaves(ref)))
    jsave(str(tmp_path / "again"), got2, step=2)
    back, _ = restore_checkpoint(str(tmp_path / "again"), port_state)
    assert all(_bits(back_leaf) == _bits(v) for (_, back_leaf), (_, v) in
               zip(named_leaves(back), named_leaves(port_state)))


def test_elastic_restart_from_checkpoint(tmp_path):
    """Stop after step 2, restore, go on: the state equals an uninterrupted
    run's bit for bit (the port's counterpart of the reference's test)."""
    params, batch = _inputs()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = sgd(0.1)
    step = psh.make_train_step(loss_fn, opt, psh.IplsStepConfig(use_eps=False, grad_clip=None))

    def fresh():
        return psh.init_state({"w": torch.from_numpy(params["w"].copy())}, opt)

    s = fresh()
    for _ in range(4):
        s, _ = step(s, tb)
    w_ref = s.params["w"].clone()

    mgr = CheckpointManager(str(tmp_path))
    s = fresh()
    for _ in range(2):
        s, _ = step(s, tb)
    mgr.save(s, step=2)
    restored, step_no = mgr.restore_latest(fresh())
    assert step_no == 2 and int(restored.step) == 2
    s2 = psh.IplsTrainState(*restored)
    for _ in range(2):
        s2, _ = step(s2, tb)
    assert torch.equal(s2.params["w"], w_ref) and int(s2.step) == 4

    # with Adam, the optimizer state crosses too
    opt = adam(1e-2)
    step = psh.make_train_step(loss_fn, opt, psh.IplsStepConfig(grad_clip=1.0))
    s = psh.init_state({"w": torch.from_numpy(params["w"].copy())}, opt)
    states = []
    for i in range(4):
        s, _ = step(s, tb)
        if i == 1:
            mgr.save(s, step=12)
            states.append(mgr.restore_latest(s)[0])
    s2 = psh.IplsTrainState(*states[0])
    for _ in range(2):
        s2, _ = step(s2, tb)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(s), named_leaves(s2)))
