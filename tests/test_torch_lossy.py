"""The port's batched engine under LOSSY networks against the JAX scalar engine.

The event-driven path of ``repro_torch.fl.vectorized`` (fate stream, event
rings, delta ring, cache plane) on the CPU, where its kernels take their
plain versions, against the reference's scalar engine on the same data and
config: per round ``bytes_total`` and ``active`` exactly equal and accuracy
within 5e-3; ``messages_sent`` and ``messages_dropped`` exactly equal; final
weights within 1e-4 (float32 GEMM sums in other orders, the bound the
reference's own engines are held to). Configs: the reference's LOSSY seeds
and lossy corners (``tests/test_vectorized.py``).

Max |weight difference| measured on the CPU: seeds 0, 1, 2: 4.5e-8, 3.0e-8,
2.7e-5; corners rho1, rho3, loss-only, delay-only, deep: 7.0e-5, 4.5e-8,
4.5e-8, 3.0e-8, 3.0e-8. The port's scalar engine lands as far from the
reference on the two largest (2.7e-5, 1.1e-5): float noise of the local
SGD, grown over four rounds of aggregation.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.models import mlp_mnist
from repro_torch.p2p.network import LOSSY, NetworkConditions

SEEDS = [0, 1, 2]
CORNERS = [
    # rho=1: every loss is unrecoverable for the round; delayed updates
    # pile onto the single holder next round
    dict(num_agents=4, num_partitions=6, pi=2, rho=1, seed=5),
    # rho=3 exercises the replica-consensus masks + version filtering
    dict(num_agents=6, num_partitions=5, pi=2, rho=3, seed=6),
    # loss-only and delay-only corners of NetworkConditions
    dict(num_agents=4, num_partitions=6, pi=2, rho=2, seed=7,
         conditions=NetworkConditions(loss_prob=0.4)),
    dict(num_agents=4, num_partitions=6, pi=2, rho=2, seed=8,
         conditions=NetworkConditions(delay_prob=0.5, max_delay_rounds=2)),
    # delays longer than one round: a deeper delta ring
    dict(num_agents=4, num_partitions=6, pi=2, rho=2, seed=9,
         conditions=NetworkConditions(loss_prob=0.2, delay_prob=0.5, max_delay_rounds=6)),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The runs here are many small products, which torch's thread pool
    slows down when several test processes share the cores: run them on
    one thread (no numeric effect: both sides of every comparison run in
    this process), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synth_mnist(num_train=1500, num_test=300, seed=0)


def run_jax_scalar(data, kw):
    from repro.fl import IPLSSimulation
    from repro.fl import SimConfig as JaxConfig
    from repro.p2p.network import NetworkConditions as JaxConditions

    cond = kw.get("conditions")
    if cond is not None:
        kw = dict(kw, conditions=JaxConditions(**dataclasses.asdict(cond)))
    cfg = JaxConfig(**kw)
    x_tr, y_tr, x_te, y_te = data
    sim = IPLSSimulation(cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te)
    sim.run()
    return sim


def run_port(data, kw, engine="vectorized"):
    x_tr, y_tr, x_te, y_te = data
    cfg = SimConfig(engine=engine, **kw)
    sim = make_simulation(
        cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te, device="cpu"
    )
    sim.run()
    return sim


def assert_matches_jax_scalar(data, kw, atol_w=1e-4):
    jsim = run_jax_scalar(data, kw)
    vsim = run_port(data, kw)
    for mj, mv in zip(jsim.history, vsim.history, strict=True):
        assert mj["round"] == mv["round"] and mj["active"] == mv["active"]
        assert mj["bytes_total"] == mv["bytes_total"]
        np.testing.assert_allclose(mv["acc_mean"], mj["acc_mean"], atol=5e-3)
    assert vsim.messages_sent == jsim.net.pubsub.messages_sent
    assert vsim.messages_dropped == jsim.net.pubsub.messages_dropped
    w_j = np.stack([jsim.agents[a].load_model() for a in range(kw["num_agents"])])
    np.testing.assert_allclose(vsim.agent_weights(), w_j, atol=atol_w)
    return vsim


@pytest.mark.parametrize("seed", SEEDS)
def test_lossy_seeds_match_jax_scalar(data, seed):
    kw = dict(num_agents=5, num_partitions=8, pi=2, rho=2, conditions=LOSSY, seed=seed,
              rounds=4, local_iters=3)
    vsim = assert_matches_jax_scalar(data, kw)
    assert vsim.messages_dropped > vsim.net.pubsub.messages_dropped  # losses happened
    assert vsim.R_cap == 1 + (5 - 1) * 2  # LOSSY delays <= 2 ticks: one round late


@pytest.mark.parametrize("kw", CORNERS, ids=["rho1", "rho3", "loss-only", "delay-only", "deep"])
def test_lossy_corners_match_jax_scalar(data, kw):
    kw = dict(dict(conditions=LOSSY, rounds=4, local_iters=3), **kw)
    vsim = assert_matches_jax_scalar(data, kw)
    if kw["conditions"].loss_prob > 0:
        assert vsim.messages_dropped > vsim.net.pubsub.messages_dropped


@pytest.mark.parametrize("kw", CORNERS, ids=["rho1", "rho3", "loss-only", "delay-only", "deep"])
def test_lossy_corners_bitwise_equal_to_port_scalar_without_sgd_noise(data, monkeypatch, kw):
    """With the local SGD in float64 (rounded to float32 once per round, so
    per-agent and batched products give the same bits), the batched engine
    equals the port's scalar engine, which runs the reference's numpy
    protocol message by message, bit for bit."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    monkeypatch.setattr(
        mlp_mnist, "sgd_steps_flat_batched",
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float(),
    )
    kw = dict(dict(conditions=LOSSY, rounds=4, local_iters=3), **kw)
    ssim = run_port(data, kw, "scalar")
    vsim = run_port(data, kw)
    assert [h["bytes_total"] for h in vsim.history] == [h["bytes_total"] for h in ssim.history]
    ps = ssim.net.pubsub
    assert (vsim.messages_sent, vsim.messages_dropped) == (ps.messages_sent, ps.messages_dropped)
    w_s = np.stack([ssim.agents[a].load_model() for a in range(kw["num_agents"])])
    np.testing.assert_array_equal(vsim.agent_weights(), w_s)
