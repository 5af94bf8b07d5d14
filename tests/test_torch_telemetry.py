"""The port's telemetry units against the reference's, on the CPU.

``repro_torch.telemetry`` is a copy of ``repro.telemetry`` in PyTorch: the
same schema tables, so a stream from either package loads in the other's
report; the same recorder, so the same taps give the same JSONL bytes; the
same channel mapping as the keyed fate stream; the same Chrome trace; the
same report digest. The pubsub taps of ``repro_torch.p2p.ipfs_sim`` make
the same calls as the reference's, message for message. The engines'
streams are tested in tests/test_torch_telemetry_engines.py.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.api import FETCH_TOPIC, MEMBER_TOPIC, REPLICA_TOPIC, REPLY_TOPIC, UPDATE_TOPIC
from repro_torch.fl.rounds import (
    CH_FETCH,
    CH_FETCH_REPLY,
    CH_MEMBER,
    CH_REPLICA,
    CH_UPDATE,
    CH_UPDATE_REPLY,
    TICKS_PER_ROUND,
    MessageFates,
)
from repro_torch.p2p.ipfs_sim import PubSub
from repro_torch.p2p.network import NetworkConditions
from repro_torch.telemetry import (
    CHANNELS,
    FINISH_KEYS,
    ROW_KEYS,
    SCHEMA_VERSION,
    TELEMETRY_SCHEMA,
    MetricsRecorder,
    PhaseTimer,
    TraceWriter,
    report,
)
from repro_torch.telemetry.device import host_normsq, metric_pair, normsq

SRC = Path(__file__).resolve().parents[1] / "src"
TOPICS = [UPDATE_TOPIC, FETCH_TOPIC, REPLY_TOPIC, f"{REPLICA_TOPIC}/3", MEMBER_TOPIC]


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


def _jax_telemetry():
    import repro.telemetry as jt

    return jt


def test_schema_tables_equal_the_reference():
    from repro.telemetry import schema as js

    assert SCHEMA_VERSION == js.SCHEMA_VERSION == 1
    assert CHANNELS == js.CHANNELS
    assert FINISH_KEYS == js.FINISH_KEYS
    assert list(TELEMETRY_SCHEMA.items()) == list(js.TELEMETRY_SCHEMA.items())
    assert ROW_KEYS == js.ROW_KEYS


def _feed(rec, seed: int, n_rounds: int = 3, max_delay: int = 2) -> None:
    """A random mix of every tap, then one finish_round a round."""
    rng = np.random.default_rng(seed)
    for rnd in range(n_rounds):
        for _ in range(40):
            topic = TOPICS[rng.integers(len(TOPICS))]
            ctr = TICKS_PER_ROUND * rnd + int(rng.integers(TICKS_PER_ROUND))
            s, r = int(rng.integers(6)), int(rng.integers(6))
            kind = rng.integers(5)
            if kind == 0:
                rec.on_send(topic, ctr, s, int(rng.integers(1, 5000)))
            elif kind == 1:
                delivered, delay = bool(rng.integers(2)), int(rng.integers(max_delay + 1))
                rec.on_fate(topic, ctr, s, r, delivered, delay)
            elif kind == 2:
                rec.on_delivery(topic, ctr, ctr + int(rng.integers(3)), s, r, 100)
            elif kind == 3:
                rec.on_offline_drop(ctr)
            else:
                rec.on_offline_drops(rnd, int(rng.integers(3)))
        ch = CHANNELS[rng.integers(len(CHANNELS))]
        rec.on_channel(rnd, ch, int(rng.integers(9)), int(rng.integers(9000)), int(rng.integers(3)))
        rec.on_delays(rnd, rng.integers(0, max_delay + 1, size=int(rng.integers(0, 20))))
        rec.on_delivered(rnd, int(rng.integers(max_delay + 1)), int(rng.integers(4)))
        k_inst = 5
        rec.finish_round(
            round=rnd, active=int(rng.integers(1, 7)),
            contrib=[int(c) for c in rng.integers(0, 5, k_inst)],
            eps=[float(e) for e in rng.random(k_inst)],
            delta_normsq=float(np.float32(rng.random() * 10)),
            value_normsq=float(np.float32(rng.random() * 1e3)),
            accs=rng.random(3).astype(np.float32),
            bytes_total=int(rng.integers(1e6)), msgs_total=int(rng.integers(1e4)),
            drops_total=int(rng.integers(100)),
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_taps_give_the_same_bytes(seed):
    jt = _jax_telemetry()
    mine = MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=2, trace=TraceWriter())
    ref = jt.MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=2,
                             trace=jt.TraceWriter())
    _feed(mine, seed)
    _feed(ref, seed)
    meta = {"engine": "scalar", "seed": seed}
    assert mine.jsonl_lines(meta) == ref.jsonl_lines(meta)
    assert mine.trace.events == ref.trace.events
    for row in mine.rows:
        assert tuple(row) == ROW_KEYS


def test_channel_mapping_matches_the_fates():
    """Every (topic, tick phase) maps onto the channel whose fate key
    ``MessageFates.pubsub_fate`` draws, and onto the reference recorder's
    channel."""
    jt = _jax_telemetry()
    rec = MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=2)
    ref = jt.MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=2)
    drawn = []

    class Spy(MessageFates):
        def draw_one(self, channel, rnd, agent, part, peer=0):
            drawn.append(channel)
            return True, 0

    fates = Spy(NetworkConditions(), 0)
    code = {CH_FETCH: "fetch", CH_FETCH_REPLY: "fetch_reply", CH_UPDATE: "update",
            CH_UPDATE_REPLY: "update_reply", CH_REPLICA: "replica", CH_MEMBER: "member"}
    assert tuple(code[c] for c in sorted(code)) == CHANNELS
    for topic in TOPICS:
        for ctr in range(2 * TICKS_PER_ROUND):
            fates.pubsub_fate(topic, 1, 2, (0, None), ctr)
            assert rec._channel(topic, ctr) == code[drawn[-1]] == ref._channel(topic, ctr)


def _drive_pubsub(ps, seed: int) -> None:
    """Publishes, sends and ticks with agents going offline and back."""
    rng = np.random.default_rng(seed)
    for a in range(5):
        for topic in TOPICS:
            ps.subscribe(topic, a)
    for _ in range(3 * TICKS_PER_ROUND):
        for _ in range(6):
            topic = TOPICS[rng.integers(len(TOPICS))]
            s, r = int(rng.integers(5)), int(rng.integers(5))
            if rng.integers(2):
                ps.publish(topic, s, (int(rng.integers(4)), None), int(rng.integers(1, 900)))
            else:
                ps.send(topic, s, r, (int(rng.integers(4)), None), int(rng.integers(1, 900)))
        ps.set_offline(int(rng.integers(5)), bool(rng.integers(2)))
        ps.tick()


def test_pubsub_taps_match_the_reference():
    """The port's pubsub and the reference's, each with its recorder, on the
    same traffic under a keyed lossy, delayed fate stream and offline
    agents: the same counters, the same rows, the same trace events."""
    import repro.fl.rounds as jrounds
    import repro.p2p.ipfs_sim as jps
    import repro.p2p.network as jnet

    jt = _jax_telemetry()
    kw = dict(loss_prob=0.3, delay_prob=0.5, max_delay_rounds=3)
    mine, ref = PubSub(NetworkConditions(**kw)), jps.PubSub(jnet.NetworkConditions(**kw))
    mine.fate_source = MessageFates(mine.conditions, 5).pubsub_fate
    ref.fate_source = jrounds.MessageFates(ref.conditions, 5).pubsub_fate
    mine.telemetry = MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=3,
                                     trace=TraceWriter())
    ref.telemetry = jt.MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=3,
                                       trace=jt.TraceWriter())
    _drive_pubsub(mine, 7)
    _drive_pubsub(ref, 7)
    assert (mine.messages_sent, mine.messages_dropped) == (ref.messages_sent, ref.messages_dropped)
    assert mine.messages_dropped > 0
    for rec, ps in ((mine.telemetry, mine), (ref.telemetry, ref)):
        for rnd in range(3):
            rec.finish_round(round=rnd, active=5, contrib=[1], eps=[1.0], delta_normsq=0.0,
                             value_normsq=0.0, accs=[0.5], bytes_total=ps.total_bytes(),
                             msgs_total=ps.messages_sent, drops_total=ps.messages_dropped)
    assert mine.telemetry.jsonl_lines() == ref.telemetry.jsonl_lines()
    assert mine.telemetry.trace.events == ref.telemetry.trace.events
    rows = mine.telemetry.rows
    assert sum(r["drops_offline"] for r in rows) > 0
    # every message sent is counted on its channel
    assert sum(r[f"msgs_{ch}"] for r in rows for ch in CHANNELS) == mine.messages_sent


def test_pubsub_without_a_recorder_counts_the_same():
    kw = dict(loss_prob=0.3, delay_prob=0.5, max_delay_rounds=3)
    on, off = PubSub(NetworkConditions(**kw)), PubSub(NetworkConditions(**kw))
    for ps in (on, off):
        ps.fate_source = MessageFates(ps.conditions, 5).pubsub_fate
    on.telemetry = MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=3)
    _drive_pubsub(on, 3)
    _drive_pubsub(off, 3)
    assert off.telemetry is None
    assert (on.messages_sent, on.messages_dropped, dict(on.bytes_sent), dict(on.bytes_recv)) == (
        off.messages_sent, off.messages_dropped, dict(off.bytes_sent), dict(off.bytes_recv))


def test_trace_is_chrome_trace_shaped(tmp_path):
    tw = TraceWriter()
    tw.instant("send update", 5, 2, {"bytes": 10})
    tw.instant("drop fetch", 6, 1)
    pt = PhaseTimer(trace=tw)
    with pt.phase("control"):
        pass
    doc = tw.to_dict()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"M", "i", "X"}
    for ev in events:
        assert {"name", "ph", "pid"} <= set(ev)
        if ev["ph"] in ("i", "X"):
            assert ev["ts"] >= 0
    assert [e["ts"] for e in events if e["pid"] == 1 and e["ph"] == "i"] == [5000, 6000]
    assert [e["name"] for e in events if e["pid"] == 2 and e["ph"] == "X"] == ["control"]
    out = tmp_path / "run.trace.json"
    tw.write(str(out))
    assert json.loads(out.read_text()) == doc
    # the metadata track names are the reference's
    ref = _jax_telemetry().TraceWriter().to_dict()
    assert doc["traceEvents"][:2] == ref["traceEvents"][:2]


def test_phase_timer_records_host_spans():
    tw = TraceWriter()
    pt = PhaseTimer(trace=tw)
    for _ in range(2):
        with pt.phase("fate_draw"):
            pass
    with pt.phase("device_window"):
        pass
    s = pt.summary()
    assert s["fate_draw"]["count"] == 2 and s["device_window"]["count"] == 1
    assert s["fate_draw"]["total_s"] >= 0
    spans = [e for e in tw.events if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["fate_draw", "fate_draw", "device_window"]
    assert all(e["pid"] == 2 and e["dur"] >= 0 for e in spans)
    assert PhaseTimer().trace is None and PhaseTimer.sync


def test_device_metric_math():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((5, 1003)).astype(np.float32)
    v = rng.standard_normal((4, 300)).astype(np.float32)
    D, V = torch.as_tensor(d), torch.as_tensor(v)
    pair = metric_pair(D, V)
    assert pair.dtype == torch.float32 and pair.shape == (2,)
    assert pair[0].item() == normsq(D).item() == host_normsq(d, "cpu")
    assert pair[1].item() == host_normsq(v, "cpu")
    # a non-contiguous plane reduces as its contiguous copy
    assert host_normsq(np.asfortranarray(d), "cpu") == host_normsq(d, "cpu")
    np.testing.assert_allclose(pair.numpy(), [np.sum(d.astype(np.float64) ** 2),
                                              np.sum(v.astype(np.float64) ** 2)], rtol=1e-6)


def _stream(tmp_path, name="m.jsonl", seed=0):
    rec = MetricsRecorder(ticks_per_round=TICKS_PER_ROUND, max_delay_ticks=2)
    _feed(rec, seed, n_rounds=4)
    path = tmp_path / name
    rec.write_jsonl(str(path), meta={"engine": "vectorized"})
    return path


def test_report_digest_equals_the_reference(tmp_path, capsys):
    from repro.telemetry import report as jreport

    path = _stream(tmp_path)
    head, rows = report.load_stream(str(path))
    assert head == {"schema_version": SCHEMA_VERSION, "meta": {"engine": "vectorized"}}
    assert report.summarize(rows) == jreport.summarize(jreport.load_stream(str(path))[1])
    assert report.summarize(rows)["rounds"] == 4
    outs = []
    for main in (report.main, jreport.main):
        assert main([str(path), "--json"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
        assert main([str(path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert "rounds 0..3 (4 rows)" in outs[1]


def test_report_rejects_a_foreign_schema(tmp_path):
    from repro.telemetry import report as jreport

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema_version":99,"meta":{}}\n')
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for path in (bad, empty):
        assert report.main([str(path)]) == 1
        assert jreport.main([str(path)]) == 1
        with pytest.raises(ValueError):
            report.load_stream(str(path))


def test_report_runs_as_a_module(tmp_path):
    """``python -m repro_torch.telemetry.report PATH --json`` and its package
    form, as a user runs them."""
    path = _stream(tmp_path, seed=4)
    want = report.summarize(report.load_stream(str(path))[1])
    for mod in ("repro_torch.telemetry.report", "repro_torch.telemetry"):
        out = subprocess.run(
            [sys.executable, "-m", mod, str(path), "--json"], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120, check=True,
        ).stdout
        assert json.loads(out) == {str(path): want}
