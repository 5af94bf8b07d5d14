"""Round-structured IPLS simulation: the paper's experiments, end to end.

Wires together: SimIPFS substrate (loss/delay), PartitionTable (pi/rho),
IPLSAgent middleware (Init/UpdateModel/LoadModel/Terminate), LocalTrainer
(local SGD on the agent's private shard), churn schedules, and evaluation.

One simulated round =
  train -> UpdateModel -> tick -> collect -> aggregate -> replies/replica
  sync -> tick -> receive -> (evaluate)
which matches the paper's asynchronous round structure: messages delayed past
a tick are picked up in a later round; lost messages simply never arrive and
the eps-weighting absorbs the shrunken contributor count r.

Counterpart of ``repro.fl.rounds``. The protocol is the reference's numpy
code, message for message (any ``NetworkConditions``, either wire format,
churn); local SGD and evaluation run in PyTorch on the simulation's device.
``cfg.telemetry`` attaches a ``MetricsRecorder`` (per-message pubsub taps,
one schema row per round through ``_tel_finish``), ``cfg.trace`` its trace.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import (
    FETCH_TOPIC,
    IPLSAgent,
    REPLICA_TOPIC,
    REPLY_TOPIC,
    UPDATE_TOPIC,
    reset_registry,
)
from repro_torch.core.partition import PartitionSpec, PartitionTable, flatten_params
from repro_torch.core.wire import BLOCK, make_wire
from repro_torch.device import resolve_device
from repro_torch.fl.local_trainer import LocalTrainer
from repro_torch.models import mlp_mnist
from repro_torch.p2p.ipfs_sim import SimIPFS
from repro_torch.p2p.network import PERFECT, NetworkConditions
from repro_torch.telemetry import NULL_TIMER, MetricsRecorder, TraceWriter
from repro_torch.telemetry.device import host_normsq

# the simulation ticks the substrate 4 times per training round (after the
# fetch requests, the fetch replies, the UpdateModel sends, and the
# reply/replica sends); NetworkConditions delays are in TICK units
TICKS_PER_ROUND = 4

# message channels of the keyed fate stream (see MessageFates)
CH_FETCH, CH_FETCH_REPLY, CH_UPDATE, CH_UPDATE_REPLY, CH_REPLICA, CH_MEMBER = range(6)


class MessageFates:
    """Per-message loss/delay fates keyed by message coordinates.

    Every data-plane message of a round has canonical integer coordinates:
    (channel, round, agent, partition[, peer]). Its fate (delivered?, delay
    in ticks) is a pure hash of those coordinates
    (``NetworkConditions.sample_stream``), NOT a position in a shared
    sequential rng stream. That makes the stream order-free: the scalar
    engine looks fates up one message at a time as its pubsub sends them,
    while the vectorized engine pre-draws the whole round as (A, K) mask /
    delay tensors — both read identical values, which is what makes
    scalar<->vectorized equivalence under LOSSY conditions testable
    round-by-round (weights to float tolerance, traffic counters exactly).
    """

    def __init__(self, conditions: NetworkConditions, seed: int):
        self.conditions = conditions
        self.seed = seed

    def draw(self, channel: int, rnd, agent, part, peer=0):
        """Vectorized fate lookup; arguments broadcast together. Returns
        (delivered bool array, delay-in-ticks int array)."""
        return self.conditions.sample_stream(self.seed, channel, rnd, agent, part, peer)

    def draw_one(self, channel: int, rnd: int, agent: int, part: int, peer: int = 0):
        delivered, delay = self.draw(channel, rnd, agent, part, peer)
        return bool(delivered), int(delay)

    def draw_window(self, channel: int, rounds, agent, part, peer=0):
        """Fates for a whole window of rounds at once, as
        ``(W, *broadcast(agent, part, peer))`` arrays. Row ``w`` equals
        ``draw(channel, rounds[w], agent, part, peer)`` exactly (the stream is
        a pure hash of the coordinates), so the batched engine can draw every
        per-round mask/delay tensor of a multi-round window up front."""
        return self.conditions.sample_stream_window(
            self.seed, channel, rounds, agent, part, peer
        )

    def pubsub_fate(
        self, topic: str, sender: int, recipient: int, payload: Any, counter: int
    ) -> Tuple[bool, int]:
        """Adapter installed as ``PubSub.fate_source``: map a concrete
        pubsub message onto its keyed draw. The tick counter identifies the
        round and the phase within it (REPLY messages at phase 1 are fetch
        replies, at phase 3 UpdateModel replies)."""
        rnd, phase = divmod(counter, TICKS_PER_ROUND)
        if topic == UPDATE_TOPIC:
            return self.draw_one(CH_UPDATE, rnd, sender, payload[0])
        if topic == FETCH_TOPIC:
            return self.draw_one(CH_FETCH, rnd, sender, payload[0])
        if topic == REPLY_TOPIC:
            ch = CH_FETCH_REPLY if phase == 1 else CH_UPDATE_REPLY
            # keyed by the REQUESTER (so the requester-side mask tensors of
            # the vectorized engine line up directly) plus the serving
            # holder, so replies racing from different holders draw
            # independent fates. (Two replies from the SAME holder for the
            # same (requester, partition, round) — e.g. a delayed and an
            # on-time delta both landing on a rho=1 holder — share one fate;
            # they carry identical payloads, so only accounting correlates.)
            return self.draw_one(ch, rnd, recipient, payload[0], sender)
        if topic.startswith(REPLICA_TOPIC):
            return self.draw_one(CH_REPLICA, rnd, sender, payload[0], recipient)
        # membership topics: keyed by the pair plus the partition the event
        # concerns, so a multi-partition join/handoff burst draws an
        # independent fate per partition rather than all-or-nothing
        part = 0
        if isinstance(payload, tuple):
            if payload[0] == "join" and len(payload) >= 3:
                part = int(payload[2])
            elif payload[0] == "handoff" and len(payload) >= 2:
                part = int(payload[1])
        return self.draw_one(CH_MEMBER, rnd, sender, part, recipient)


@dataclasses.dataclass
class SimConfig:
    num_agents: int = 10
    num_partitions: int = 10
    pi: int = 2
    rho: int = 1
    alpha: float = 0.5
    rounds: int = 40
    lr: float = 0.1
    local_iters: int = 10
    batch_size: int = 128
    seed: int = 0
    eval_agents: int = 0  # evaluate at most this many agents per round (0 = all)
    conditions: NetworkConditions = PERFECT
    # churn: map round -> list of (agent_id, action) events applied at the
    # START of that round, action in "offline"|"online"|"leave"|"crash"|"join".
    # Same-round events apply in a DETERMINISTIC order regardless of list
    # order: leave/crash first, then join, then offline/online (stable within
    # each class). So {r: [(3, "join"), (3, "crash")]} always crashes the
    # pre-existing agent 3 and then admits a fresh one — it never resurrects
    # crashed state — and both engines apply the identical order.
    churn: Optional[Dict[int, List[Tuple[int, str]]]] = None
    memory: bool = True  # False = 'memoryless training' (paper Fig 3b)
    # round engine: "scalar" (per-agent loops) or "vectorized" (whole-round
    # batched device work; any network, either wire, churn — see
    # fl/vectorized.py)
    engine: str = "scalar"
    # multi-round windows of the vectorized engine: W rounds per device
    # program (one CUDA-graph replay on the card); 0 = one round at a time.
    # The scalar engine ignores it
    scan_rounds: int = 0
    # windowed-mode evaluation cadence: every c-th round and the last
    # (read only with scan_rounds > 0)
    eval_cadence: int = 1
    # data shard for agents added by a "join" churn action: a callable
    # agent_id -> (x, y). None = round-robin over the initial shards.
    join_shard: Optional[Callable[[int], Tuple[np.ndarray, np.ndarray]]] = None
    # wire format for delta / value transfers: "f32" (raw) or "int8"
    # (block-int8 + per-block scales + error feedback on the delta channel —
    # ~4x fewer bytes_total; see core/wire.py)
    wire_dtype: str = "f32"
    # observability (repro_torch.telemetry): telemetry=True attaches a
    # MetricsRecorder emitting one schema-ordered row per round, byte for
    # byte identical across the port's engines, plus per-phase wall timers;
    # trace=True adds a Chrome trace-event timeline (protocol sends,
    # deliveries and drops on simulated ticks, host phase spans). Both off by
    # default: the off path adds no device work and no per-message work
    telemetry: bool = False
    trace: bool = False


def eval_subset(live: List[int], eval_agents: int) -> List[int]:
    """Deterministic stride-spread of at most ``eval_agents`` agents over the
    live set (0 = all). Shared by both engines so they evaluate the same
    agents."""
    if eval_agents and len(live) > eval_agents:
        stride = max(len(live) // eval_agents, 1)
        live = live[::stride][:eval_agents]
    return live


def make_simulation(cfg: SimConfig, shards, x_test, y_test, device="cuda"):
    """Engine factory: returns the simulation object for ``cfg.engine``.

    Both engines expose ``run() -> List[dict]`` / ``run_round`` / ``history``
    and produce equivalent results (weights to float tolerance, traffic
    counters exactly; tests/test_torch_engine.py). The vectorized engine
    batches each round's SGD, aggregation and evaluation over all agents on
    the device and is the one to use at scale. ``device`` defaults to CUDA
    and raises without one; pass ``device="cpu"`` to run on the CPU.
    """
    if cfg.engine == "vectorized":
        from repro_torch.fl.vectorized import VectorizedIPLSSimulation

        return VectorizedIPLSSimulation(cfg, shards, x_test, y_test, device=device)
    if cfg.engine != "scalar":
        raise ValueError(f"unknown engine {cfg.engine!r}")
    return IPLSSimulation(cfg, shards, x_test, y_test, device=device)


class IPLSSimulation:
    def __init__(self, cfg: SimConfig, shards, x_test, y_test, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the test set lives on the device once, not per evaluation
        self._x_te = torch.as_tensor(x_test, device=self.device)
        self._y_te = torch.as_tensor(y_test, device=self.device)
        self._shards = shards
        reset_registry()
        self.net = SimIPFS(cfg.conditions, cfg.seed)
        # imperfect connectivity: install the keyed fate stream so every
        # message's loss/delay is a pure function of its coordinates
        self.fates: Optional[MessageFates] = None
        if cfg.conditions.loss_prob > 0 or cfg.conditions.delay_prob > 0:
            self.fates = MessageFates(cfg.conditions, cfg.seed)
            self.net.pubsub.fate_source = self.fates.pubsub_fate
        w0_params = mlp_mnist.init_params(cfg.seed)
        self.w0, self.layout = flatten_params(w0_params)
        self.spec = PartitionSpec.even(self.w0.size, cfg.num_partitions)
        self.table = PartitionTable(cfg.num_partitions, cfg.pi, cfg.rho)
        self.wire = make_wire(cfg.wire_dtype)
        self.agents: Dict[int, IPLSAgent] = {}
        self.trainers: Dict[int, LocalTrainer] = {}
        for a in range(cfg.num_agents):
            agent = IPLSAgent(a, self.net, self.table, self.spec, cfg.alpha, wire=self.wire)
            agent.init(self.w0 if a == 0 else None)
            self.agents[a] = agent
            x, y = shards[a]
            self.trainers[a] = self._trainer(a, x, y)
        # joiner shard bookkeeping (see _next_free_shard): shard index backing
        # each trainer created from self._shards, and the round-robin cursor
        self._trainer_shard: Dict[int, int] = {a: a for a in range(cfg.num_agents)}
        self._join_rr = 0
        self.history: List[dict] = []
        # phase timer: assign a telemetry.PhaseTimer to time the round phases
        self.timer = NULL_TIMER
        # observability: attached AFTER init, so the join/bootstrap traffic
        # stays out of the per-round rows of every engine (it still shows in
        # the cumulative *_total counters through the pubsub)
        self.recorder: Optional[MetricsRecorder] = None
        if cfg.telemetry:
            self.recorder = MetricsRecorder(
                ticks_per_round=TICKS_PER_ROUND,
                max_delay_ticks=cfg.conditions.max_delay_rounds,
                trace=TraceWriter() if cfg.trace else None,
            )
            self.timer = self.recorder.timer
            self.net.pubsub.telemetry = self.recorder
            # the instance width of the batched engine's value planes (int8:
            # whole quantization blocks)
            s_max = int(max(self.spec.sizes))
            self._tel_S = -(-s_max // BLOCK) * BLOCK if cfg.wire_dtype == "int8" else s_max

    def _trainer(self, agent_id: int, x, y) -> LocalTrainer:
        cfg = self.cfg
        return LocalTrainer(
            agent_id, x, y, cfg.lr, cfg.local_iters, cfg.batch_size, cfg.seed, self.device
        )

    # -- churn handling -----------------------------------------------------
    # Same-round events are applied in a deterministic class order (see the
    # SimConfig.churn comment): departures first, then joins, then
    # offline/online toggles; the sort is stable so same-class events keep
    # their schedule order. The vectorized engine replays event rounds
    # through this same method, so both engines agree by construction.
    _CHURN_ORDER = {"leave": 0, "crash": 0, "join": 1, "offline": 2, "online": 2}

    def _apply_churn(self, rnd: int) -> None:
        if not self.cfg.churn:
            return
        events = sorted(
            self.cfg.churn.get(rnd, []),
            key=lambda ev: self._CHURN_ORDER.get(ev[1], 3),
        )
        for agent_id, action in events:
            if action == "offline":
                self.net.pubsub.set_offline(agent_id, True)
            elif action == "online":
                self.net.pubsub.set_offline(agent_id, False)
                if not self.cfg.memory and agent_id in self.agents:
                    # memoryless rejoin: lose the cached global parts
                    self.agents[agent_id].cache.clear()
            elif action == "leave":
                if agent_id in self.agents:
                    self.agents[agent_id].terminate()
            elif action == "crash":
                if agent_id in self.agents:
                    self.agents[agent_id].crash()
            elif action == "join":
                agent = IPLSAgent(
                    agent_id, self.net, self.table, self.spec, self.cfg.alpha, wire=self.wire
                )
                agent.init()
                self.agents[agent_id] = agent
                # a joiner without a trainer never contributes a delta
                # (run_round skips training for agents not in self.trainers):
                # give it a data shard so it participates
                if agent_id not in self.trainers:
                    if self.cfg.join_shard is not None:
                        x, y = self.cfg.join_shard(agent_id)
                    else:
                        shard_idx = self._next_free_shard(agent_id)
                        self._trainer_shard[agent_id] = shard_idx
                        x, y = self._shards[shard_idx]
                    self.trainers[agent_id] = self._trainer(agent_id, x, y)

    def _next_free_shard(self, agent_id: int) -> int:
        """Pick a data shard for a joiner: round-robin over shards not held
        by any live agent's trainer, so a joiner whose id aliases an active
        agent's shard index does not double-count that data in the average.
        Falls back to ``agent_id % len(shards)`` only when every shard is
        taken."""
        used = {
            self._trainer_shard[a]
            for a, ag in self.agents.items()
            if ag.live and a != agent_id and a in self._trainer_shard
        }
        n = len(self._shards)
        free = [i for i in range(n) if i not in used]
        if not free:
            return agent_id % n
        for _ in range(n):
            idx = self._join_rr % n
            self._join_rr += 1
            if idx in free:
                return idx
        return free[0]

    def _live_online(self) -> List[int]:
        return [
            a
            for a, ag in self.agents.items()
            if ag.live and not self.net.pubsub.is_offline(a)
        ]

    # -- one round ------------------------------------------------------------
    def run_round(self, rnd: int) -> dict:
        self._apply_churn(rnd)
        active = self._live_online()
        pt = self.timer
        rec = self.recorder

        # 0. collect missing global parameters (paper: 'each agent initially
        # contacts enough agents to collect the global parameters'; also how
        # rejoining agents warm back up)
        with pt.phase("fetch"):
            for a in active:
                self.agents[a].request_missing(rnd)
            self.net.tick()
            for a in active:
                self.agents[a].serve_fetches()
            self.net.tick()
            for a in active:
                self.agents[a].receive_replies()

        # 1. local training + UpdateModel
        deltas: List[np.ndarray] = []
        with pt.phase("train"):
            for a in active:
                if a not in self.trainers:
                    continue
                w = self.agents[a].load_model()
                delta = self.trainers[a].train_delta(w)
                if rec is not None:
                    deltas.append(delta)
                self.agents[a].update_model(delta, rnd)
            self.net.tick()

        # 2. holders aggregate + reply; replicas sync
        with pt.phase("aggregate"):
            for a in active:
                self.agents[a].collect()
            # contributor counts: captured between drain and aggregate, when
            # every instance's pending buffer holds this round's full r
            instances = contrib = None
            if rec is not None:
                instances = self._tel_instances()
                contrib = [st.pending_n if st is not None else 0
                           for st in self._tel_states(instances)]
            for a in active:
                self.agents[a].aggregate()
            for a in active:
                self.agents[a].serve_replies()
                self.agents[a].sync_replicas(rnd)
            self.net.tick()
            for a in active:
                self.agents[a].receive_replies()
                self.agents[a].merge_replicas()

        # 3. evaluate the assembled model
        with pt.phase("eval"):
            accs = self._eval_accs()
        metrics = self._acc_metrics(accs)
        metrics["round"] = rnd
        metrics["active"] = len(active)
        metrics["bytes_total"] = self.net.pubsub.total_bytes()
        self.history.append(metrics)
        if rec is not None:
            self._tel_finish(rnd, len(active), deltas, instances, contrib, accs)
        return metrics

    def evaluate(self) -> dict:
        return self._acc_metrics(self._eval_accs())

    def _eval_accs(self) -> np.ndarray:
        accs = []
        any_trainer = next(iter(self.trainers.values()))
        live = eval_subset(
            [a for a, ag in self.agents.items() if ag.live], self.cfg.eval_agents
        )
        for a in live:
            w = self.agents[a].load_model()
            accs.append(any_trainer.evaluate(w, self._x_te, self._y_te))
        return np.array(accs) if accs else np.array([0.0])

    @staticmethod
    def _acc_metrics(accs: np.ndarray) -> dict:
        return {
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std()),
            "acc_max": float(accs.max()),
        }

    # -- telemetry emission (one finish_round per round) ---------------------
    def _tel_instances(self) -> List[Tuple[int, int]]:
        """(partition, holder) instances, k-major in holder order: the row
        order of the batched engine's value planes."""
        return [(k, h) for k in range(self.cfg.num_partitions) for h in self.table.holders_of(k)]

    def _tel_states(self, instances):
        for k, h in instances:
            ag = self.agents.get(h)
            yield ag.owned.get(k) if ag is not None else None

    def _tel_finish(self, rnd, n_active, deltas, instances, contrib, accs):
        """The engine's one emission site. The norms reduce the planes the
        batched engine reduces, with the same shapes on the same device: the
        (n_active, N) delta rows in training order and the (K_inst, S) value
        plane (``telemetry.device``)."""
        V = np.zeros((len(instances), self._tel_S), np.float32)
        eps = []
        for i, st in enumerate(self._tel_states(instances)):
            if st is not None:
                V[i, : st.value.size] = st.value
                eps.append(st.eps)
            else:
                eps.append(1.0)
        dn = host_normsq(np.stack(deltas), self.device) if deltas else 0.0
        self.recorder.finish_round(
            round=rnd,
            active=n_active,
            contrib=contrib,
            eps=eps,
            delta_normsq=dn,
            value_normsq=host_normsq(V, self.device),
            accs=accs,
            bytes_total=self.net.pubsub.total_bytes(),
            msgs_total=self.net.pubsub.messages_sent,
            drops_total=self.net.pubsub.messages_dropped,
        )

    def run(self) -> List[dict]:
        for rnd in range(self.cfg.rounds):
            self.run_round(rnd)
        return self.history
