"""The port's batched engine on the int8 wire against the JAX scalar engine.

The event-driven path with the block-int8 codec (error feedback on the
delta plane, quantize->dequantize images of every value that crossed the
wire, the quantized aggregation kernel's plain version on the CPU), on the
reference's quantized-wire matrix (``tests/test_quantized.py``): LOSSY at
rho 1/2/3, PERFECT int8, and the LOSSY f32 control. Against the reference's
scalar engine: per round ``bytes_total`` exactly equal and accuracy within
5e-3; ``messages_sent`` and ``messages_dropped`` exactly equal; weights
within 1e-4.

Max |weight difference| measured on the CPU: rho1 2.6e-5, rho2 1.7e-5,
rho3 1.7e-5, perfect 9.5e-6, f32-control 4.5e-8. The PERFECT case runs two
rounds: from round 3 on, two of its 1.77M weights differ from the reference
by one int8 code step (2**-10). Float noise of the local SGD moves a value
across a rounding boundary of the wire codec there, and the port's scalar
engine, which runs the reference's numpy protocol, differs by the same step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.kernels.ipls_aggregate import ops as agg_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.models import mlp_mnist
from repro_torch.p2p.network import LOSSY, PERFECT, NetworkConditions

BASE = dict(
    num_agents=4, num_partitions=4, pi=2, rounds=4, lr=0.1, local_iters=2,
    batch_size=32, eval_agents=2, seed=3, conditions=LOSSY, wire_dtype="int8",
)
MATRIX = [
    dict(rho=1),
    dict(rho=2),
    dict(rho=3),
    dict(rho=2, conditions=PERFECT, rounds=2),
    dict(rho=2, wire_dtype="f32"),  # control: the f32 plane, same matrix
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

    kw = dict(kw, conditions=JaxConditions(**dataclasses.asdict(kw["conditions"])))
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


@pytest.mark.parametrize("kw", MATRIX, ids=["rho1", "rho2", "rho3", "perfect", "f32-control"])
def test_int8_matrix_matches_jax_scalar(data, kw):
    kw = dict(BASE, **kw)
    jsim = run_jax_scalar(data, kw)
    vsim = run_port(data, kw)
    for mj, mv in zip(jsim.history, vsim.history, strict=True):
        assert mj["bytes_total"] == mv["bytes_total"]
        np.testing.assert_allclose(mv["acc_mean"], mj["acc_mean"], atol=5e-3)
    assert vsim.messages_sent == jsim.net.pubsub.messages_sent
    assert vsim.messages_dropped == jsim.net.pubsub.messages_dropped
    w_j = np.stack([jsim.agents[a].load_model() for a in range(kw["num_agents"])])
    np.testing.assert_allclose(vsim.agent_weights(), w_j, atol=1e-4)
    if kw["conditions"].loss_prob > 0:
        assert vsim.messages_dropped > 0  # losses actually happened


def test_int8_shapes_and_no_launch_on_cpu(data):
    """The int8 planes are whole 1024-blocks wide, the contributor table
    holds only remote rows, and the CPU path launches no kernel."""
    before = (q_ops.quantize.LAUNCHES, q_ops.dequantize.LAUNCHES,
              agg_ops.aggregate_batched_q.LAUNCHES, agg_ops.aggregate_batched.LAUNCHES)
    sim = run_port(data, dict(BASE, rho=2, rounds=2))
    after = (q_ops.quantize.LAUNCHES, q_ops.dequantize.LAUNCHES,
             agg_ops.aggregate_batched_q.LAUNCHES, agg_ops.aggregate_batched.LAUNCHES)
    assert after == before
    assert sim.S % 1024 == 0 and sim.S >= int(sim._sizes.max())
    assert sim.R_cap == (4 - 1) * 2  # remote rows only, delay ages 0..1
    assert sim.device_dispatches == 2 * 3


@pytest.fixture
def float64_sgd(monkeypatch):
    """Local SGD in float64, rounded to float32 once per round: removes the
    float noise by which per-agent and batched products differ."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    monkeypatch.setattr(
        mlp_mnist, "sgd_steps_flat_batched",
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float(),
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(rho=2),
        dict(rho=3, num_agents=6),
        dict(rho=2, conditions=PERFECT),
        dict(rho=2, conditions=NetworkConditions(loss_prob=0.2, delay_prob=0.5, max_delay_rounds=6)),
        dict(rho=2, wire_dtype="f32"),
    ],
    ids=["lossy-rho2", "lossy-rho3", "perfect", "deep", "f32-control"],
)
def test_engines_bitwise_equal_without_sgd_noise(data, float64_sgd, kw):
    """The batched engine against the port's scalar engine (the reference's
    numpy protocol, message by message): with the SGD noise removed, every
    weight and counter is equal bit for bit, so the event path's
    codes, residuals, contributor order and merges are exact; the int8
    differences of the float32 runs are codes flipped by that noise."""
    kw = dict(BASE, **kw)
    ssim = run_port(data, kw, "scalar")
    vsim = run_port(data, kw)
    # (accuracies agree up to the mean: float32 in the batched engine)
    np.testing.assert_allclose(
        [h["acc_mean"] for h in vsim.history], [h["acc_mean"] for h in ssim.history], atol=1e-6
    )
    assert [h["bytes_total"] for h in vsim.history] == [h["bytes_total"] for h in ssim.history]
    ps = ssim.net.pubsub
    assert (vsim.messages_sent, vsim.messages_dropped) == (ps.messages_sent, ps.messages_dropped)
    w_s = np.stack([ssim.agents[a].load_model() for a in range(kw["num_agents"])])
    np.testing.assert_array_equal(vsim.agent_weights(), w_s)
