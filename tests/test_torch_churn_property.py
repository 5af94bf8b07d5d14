"""Random churn plans on the port's batched engine against its scalar engine,
on the CPU: the property of the reference's ``tests/test_property.py``
(``test_engines_equivalent_under_random_churn``). Any schedule of the five
membership actions, memory on or off, either wire, rho 1-3, one round at a
time and in windows of 3, on the LOSSY network: traffic counters and
``active`` exactly equal every round, the live ids equal, and, with the
local SGD in float64 (the float noise by which per-agent and batched
products differ removed), every weight equal bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.models import mlp_mnist
from repro_torch.p2p.network import LOSSY

_DATA = []


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


def _data():
    if not _DATA:
        _DATA.append(synth_mnist(num_train=600, num_test=100, seed=0))
    return _DATA[0]


@settings(max_examples=3, deadline=None)
@given(
    rho=st.integers(1, 3),
    int8=st.booleans(),
    memory=st.booleans(),
    plan=st.lists(
        st.tuples(
            st.integers(1, 4),  # event round
            st.sampled_from(["offline", "online", "leave", "crash", "join"]),
        ),
        min_size=1,
        max_size=4,
    ),
)
def test_random_churn_plans_match_scalar(rho, int8, memory, plan):
    num_agents = 4
    churn = {}
    for i, (rnd, action) in enumerate(plan):
        # joins take fresh ids; every other event a distinct original
        # agent, so events never conflict on one id
        aid = num_agents + i if action == "join" else i % num_agents
        churn.setdefault(rnd, []).append((aid, action))
    x_tr, y_tr, x_te, y_te = _data()
    cfg = SimConfig(
        num_agents=num_agents, num_partitions=5, pi=2, rho=rho, rounds=6, local_iters=1,
        conditions=LOSSY, seed=0, churn=churn, memory=memory,
        wire_dtype="int8" if int8 else "f32",
    )
    shards = iid_split(x_tr, y_tr, num_agents, seed=0)
    sgd = mlp_mnist.sgd_steps_flat_batched
    mlp_mnist.sgd_steps_flat_batched = (
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float()
    )
    try:
        ssim = make_simulation(cfg, shards, x_te, y_te, device="cpu")
        ssim.run()
        ids = [a for a, ag in ssim.agents.items() if ag.live]
        ps = ssim.net.pubsub
        for scan in (0, 3):
            sim = make_simulation(dataclasses.replace(cfg, engine="vectorized", scan_rounds=scan),
                                  shards, x_te, y_te, device="cpu")
            sim.run()
            for ms, mv in zip(ssim.history, sim.history, strict=True):
                assert (ms["active"], ms["bytes_total"]) == (mv["active"], mv["bytes_total"])
            assert (sim.messages_sent, sim.messages_dropped) == (
                ps.messages_sent, ps.messages_dropped
            )
            assert sim.agent_ids() == ids
            if ids:
                w_s = np.stack([ssim.agents[a].load_model() for a in ids])
                assert sim.agent_weights().tobytes() == w_s.tobytes()
    finally:
        mlp_mnist.sgd_steps_flat_batched = sgd
