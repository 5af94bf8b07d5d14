"""The port's metric streams under churn, on the CPU.

``CHURN_ALL_ACTIONS`` (offline, leave, online, join, crash over 8 rounds; the
config of tests/test_torch_churn_port.py) on both wires, with the helpers
and bounds of tests/test_torch_telemetry_engines.py: with float64 SGD the
scalar engine, the batched engine one round at a time and in windows of 3
emit byte-identical streams through every boundary (the oracle's rounds
emit through its own emitter into the same recorder); a joiner's delta row
is the last of the plane both engines reduce; with ``eval_cadence`` a
skipped round after an oracle round carries the oracle's accuracies.
Against the JAX scalar engine the SGD-free columns are exact; on the int8
wire the schedule amplifies float32 SGD noise into flipped codes (ROADMAP
queue 3), so the norms are held to a relative 1e-3 there (measured 6.1e-4
for delta_normsq from round 4 on; 2.2e-7 on the f32 wire) and the
accuracies of two rows (rounds 6 and 7) to one test sample.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_telemetry_engines import (  # noqa: F401 (module fixtures)
    CASES,
    CHURN,
    CHURN_CASES,
    carried,
    check_against_the_jax_scalar_engine,
    check_scalar_protocol_trace_equals_jax,
    check_streams_within_the_port,
    check_telemetry_off_changes_nothing,
    check_windows_equal_rounds_with_float32_sgd,
    data,
    one_torch_thread,
    port_run,
    sgd_in,
    stream,
)

from repro_torch.data import iid_split
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.fl import rounds as port_rounds
from repro_torch.fl import vectorized as port_vec


@pytest.mark.parametrize("case", CHURN_CASES)
def test_streams_byte_identical_within_the_port(data, case):
    check_streams_within_the_port(data, case)


def test_windows_equal_rounds_with_float32_sgd(data):
    check_windows_equal_rounds_with_float32_sgd(data, "churn-int8")


@pytest.mark.parametrize("case", CHURN_CASES)
def test_against_the_jax_scalar_engine(data, case):
    check_against_the_jax_scalar_engine(data, case)


def test_scalar_protocol_trace_equals_jax(data):
    check_scalar_protocol_trace_equals_jax(data, "churn-int8")


@pytest.mark.parametrize("engine,scan", [("scalar", 0), ("vectorized", 3)])
def test_telemetry_off_changes_nothing(data, engine, scan):
    check_telemetry_off_changes_nothing(data, engine, scan, "churn-int8")


def test_eval_cadence_carries_accuracies_across_a_churn_boundary(data):
    """Windows of 3 with eval_cadence=2 under churn: each skipped round
    carries the last evaluated accuracies, the oracle round's across a
    boundary; every other byte is the scalar stream's."""
    kw = dict(CHURN, wire_dtype="int8")
    sim = port_run(data, "vectorized", "float64", scan_rounds=3, eval_cadence=2, **kw)
    scalar = port_run(data, "scalar", "float64", **kw)
    oracle = {h["round"] for h in sim._seed.history}
    evaluated = {r for r in range(kw["rounds"]) if sim._do_eval(r)} | oracle
    assert stream(sim) == carried(stream(scalar), evaluated)
    # coverage: a skipped round right after an oracle round (its accuracies
    # cross the boundary), and one before any evaluation (zeros)
    skipped = set(range(kw["rounds"])) - evaluated
    assert any(r - 1 in oracle for r in skipped) and 0 in skipped


def test_delta_rows_in_training_order_with_a_joiner(data, monkeypatch):
    """The planes each engine reduces, round by round: the scalar engine's
    stacked deltas and the batched engine's trained rows are one (n_active,
    N) matrix, bit for bit, after the join too (the joiner is the last row),
    and so are the (K_inst, S) value planes. The batched engine's oracle
    rounds reduce through the scalar path."""
    kw = dict(CHURN, churn={2: [(3, "join"), (1, "offline")], 4: [(1, "online")]}, rounds=6,
              num_agents=3, num_partitions=4)
    planes = []
    norm, pair = port_rounds.host_normsq, port_vec.metric_pair

    def host_spy(x, device):
        planes.append(np.array(x, np.float32))
        return norm(x, device)

    def pair_spy(d, v):
        planes.extend([d.numpy().copy(), v.numpy().copy()])
        return pair(d, v)

    monkeypatch.setattr(port_rounds, "host_normsq", host_spy)
    monkeypatch.setattr(port_vec, "metric_pair", pair_spy)
    x_tr, y_tr, x_te, y_te = data
    got, sims = {}, {}
    for engine in ("scalar", "vectorized"):
        planes.clear()
        cfg = SimConfig(engine=engine, telemetry=True, **kw)
        with sgd_in("float64"):
            sims[engine] = make_simulation(cfg, iid_split(x_tr, y_tr, 3, seed=0), x_te, y_te,
                                           device="cpu")
            sims[engine].run()
        got[engine] = list(planes)
    assert [h["round"] for h in sims["vectorized"]._seed.history] == [2, 4]
    assert len(got["scalar"]) == len(got["vectorized"]) == 2 * kw["rounds"]
    for a, b in zip(got["scalar"], got["vectorized"]):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # rounds 0-1: 3 trained rows; 2-3: agent 1 offline, the joiner (id 3)
    # trains last; 4-5: all 4
    assert [p.shape[0] for p in got["scalar"][::2]] == [3, 3, 3, 3, 4, 4]
    assert sims["vectorized"].agent_ids() == [0, 1, 2, 3]
    assert stream(sims["vectorized"]) == stream(sims["scalar"])
