"""Vectorized IPLS round engine on PyTorch: whole-round batching across agents.

Counterpart of ``repro.fl.vectorized``. The scalar engine (`fl/rounds.py`)
trains one agent at a time and reduces one partition at a time in numpy;
this engine runs the same per-round dataflow as a few batched device
phases, on one of two paths.

PERFECT network, f32 wire (the phase-table path):

  1. ``build_W``: every agent's flat weights, assembled as one (A, N) matrix
     from the per-instance value tables;
  2. ``sgd_all``: local SGD for all A agents at once
     (`mlp_mnist.sgd_steps_flat_batched`, one batched product per layer);
  3. ``agg_merge``: every (partition, replica-slot) instance's contributor
     deltas gathered into one (K_inst, R, S) plane and aggregated in ONE
     launch of the hand-written CUDA kernel (`kernels/ipls_aggregate`),
     then replica consensus;
  4. ``eval_rows``: evaluation of the (sub-sampled) agents in one batch.

Under PERFECT conditions with a fixed membership the scalar engine is
deterministic — every agent sends each non-owned partition's delta to
holder `H(k)[(round + agent) % rho_k]`, holders aggregate
`w -= eps * sum(deltas)` with the eps recursion, replicas mean-merge AFTER
replies are served (so caches hold pre-merge per-replica values), and agents
assemble owned->merged / cached->pre-merge views. This path replicates
exactly that, with traffic in closed form.

LOSSY networks (loss, delays of any length) and the int8 wire (the
event-driven path, the reference's kernel path): per-message fates come
from the keyed counter-based stream (`fl/rounds.MessageFates`) that the
scalar engine's pubsub reads one message at a time, so both engines see
identical loss/delay decisions. A host control plane (`_control_round`,
integer/boolean numpy over (A, K)) draws each round's fates, drains
bounded-depth event rings (serves, arrivals, replica merges, cache writes)
in the scalar inbox order, replays the eps recursion in float64, and counts
traffic exactly as the pubsub would. The device holds the value plane, an
explicit (A, K, S) cache plane, the in-flight delta ring (depth = max
delay in rounds) and the value-history rings late messages read from. Each
round: ``_pre`` (cache writes drained before LoadModel, weight assembly),
SGD, ``_core`` (aggregation through the CUDA kernel, version-filtered
replica consensus, reply-driven cache writes, evaluation). On the int8 wire
the delta plane is quantized with error feedback (`kernels/quantize`), the
ring carries codes and scales, and the quantized aggregation kernel
dequantizes inside its sum; every value that crossed the wire is stored as
its quantize->dequantize image. int8 runs this path under PERFECT
conditions too: quantized replica consensus gives each holder its own
merged value, which the phase tables cannot represent.

Both paths share one device round (`_round`): it reads one round's host
output — every agent's batch rows into the device-resident shards, the
routing tables or the control plane's fixed-shape tensors — and updates the
device state in place. Multi-round windows (``SimConfig(scan_rounds=W)``,
the reference's ``lax.scan`` windows): the host work of W rounds (fate
draws through ``MessageFates.draw_window``, the control plane, batch rows)
runs up front and is staged as (W, ...) tensors; on the card the W device
rounds are ONE CUDA-graph replay, captured at the first window of each
(W, evaluation pattern), on the CPU a plain loop of the same rounds. A
window gives the same bits as its rounds run one at a time.
``eval_cadence`` thins evaluation inside windows; a skipped round reuses
the last accuracies.

Churn (the reference's event-boundary re-snapshot): a membership schedule
sends a run onto the event path, even PERFECT f32 (the fate stream then
degenerates to delivered, delay 0). Each membership-event round replays on
the embedded scalar oracle (the `IPLSSimulation` that built the initial
state: its `_apply_churn` holds the leave/crash/join handoff rules); the
rounds between events run batched, one at a time or in windows that never
span an event round. At each boundary the device planes are written back
into the oracle's agents and every queued message is re-injected into its
pubsub (`_device_to_scalar`); the next span re-reads every membership-
dependent structure from the oracle (`_snapshot_from_scalar`): rows are the
live agents in the oracle's order, offline agents keep their rows but train
on none, and the oracle's in-flight messages move into the rings and a
span-constant mail plane (`_harvest_pubsub`). Graphs captured in one span
are dropped at the next re-snapshot.

Telemetry (``SimConfig(telemetry=True)``, the reference's recorder): the
engine emits the seed simulation's stream through its recorder, one row a
round (`_emit_row`). Traffic comes from the closed forms (PERFECT) or the
control plane's taps, per channel and round, before the device rounds run;
contributor counts and float64 eps are per-round host snapshots; the two
norm columns are an auxiliary (2,) output of each device round (a (W, 2)
buffer of the window's graph), reduced on the planes the scalar engine
reduces. With telemetry off the rounds run exactly the kernels they run
without it. Oracle rounds emit through the oracle's own emitter into the
same recorder.

On the CPU both paths run the same dataflow with the kernels' plain
versions, so the CPU tests test what the card runs. Both engines agree to
float tolerance round by round, traffic counters exactly
(tests/test_torch_engine.py, test_torch_lossy.py, test_torch_int8.py,
test_torch_window.py, test_torch_churn*.py), and their metric streams byte
for byte once SGD float noise is removed (test_torch_telemetry*.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import FETCH_TOPIC, REPLICA_TOPIC, REPLY_TOPIC, UPDATE_TOPIC
from repro_torch.core.partition import unflatten_params
from repro_torch.core.wire import BLOCK, qdq_rows, quantize_rows, wire_size
from repro_torch.device import resolve_device
from repro_torch.fl.local_trainer import TrainingRows
from repro_torch.fl.rounds import (
    CH_FETCH,
    CH_FETCH_REPLY,
    CH_REPLICA,
    CH_UPDATE,
    CH_UPDATE_REPLY,
    TICKS_PER_ROUND,
    IPLSSimulation,
    MessageFates,
    eval_subset,
)
from repro_torch.kernels._build import Graph
from repro_torch.kernels.ipls_aggregate.ops import aggregate_batched, aggregate_batched_q
from repro_torch.models import mlp_mnist
from repro_torch.p2p.ipfs_sim import Message
from repro_torch.telemetry import NULL_TIMER
from repro_torch.telemetry.device import metric_pair
from repro_torch.telemetry.timing import device_phase

# cache-event value sources (see _control_round)
_KIND_START = 0  # holder value at the start of the serve round (fetch reply)
_KIND_AGG = 1  # holder value after aggregation, pre-merge (UpdateModel reply)
_KIND_MAIL = 2  # harvested in-flight reply payload (the span's mail plane)


class _HarvestDeferred(Exception):
    """A span-boundary harvest met an in-flight message the dense planes
    cannot represent (possible only when max_delay_rounds exceeds one round
    of ticks, e.g. a straggler whose sender has since left). The caller
    replays one more round on the scalar oracle and retries: stragglers
    drain within max_delay, so the retry converges."""


class _FateWindow:
    """The request-side fates of rounds r0 .. r0+W-1 (`MessageFates.draw_window`).

    The request-side channels (fetch, UpdateModel, replica publish) have
    fixed per-round keys, so the (W, ...) mask/delay arrays of a window (of
    one round, one round at a time) are drawn in one hashing pass up front;
    the reply channels stay per-event draws inside the control plane (their
    keys depend on which messages arrived). A fate is a pure hash of its
    coordinates, so round t's slice is the scalar pubsub's draws."""

    def __init__(self, fates, r0, W, a_col, k_row, rep_src_agent, rep_k, rep_dst_agent):
        rounds = np.arange(r0, r0 + W)
        self.r0 = r0
        self.fetch = fates.draw_window(CH_FETCH, rounds, a_col, k_row)
        self.update = fates.draw_window(CH_UPDATE, rounds, a_col, k_row)
        self.replica = (
            fates.draw_window(CH_REPLICA, rounds, rep_src_agent, rep_k, rep_dst_agent)
            if len(rep_src_agent)
            else None
        )

    def slice(self, name: str, t: int):
        de, dl = getattr(self, name)
        return de[t - self.r0], dl[t - self.r0]


@dataclasses.dataclass
class WindowGraph:
    """One captured window: the graph (it counts its replays and the kernel
    launches each makes), its static inputs (rewritten before each replay),
    its (W, E) accuracy output and, with telemetry on, its (W, 2) norm
    metrics (``telemetry.device.metric_pair`` of each round)."""

    graph: Graph
    inputs: Dict[str, torch.Tensor]
    accs: torch.Tensor
    mets: Optional[torch.Tensor]


class VectorizedIPLSSimulation:
    """Batched engine with the same interface as `IPLSSimulation`.

    Construction delegates to the scalar engine so the bootstrap/join
    protocol (partition transfers, donor caches, membership traffic) is
    byte-for-byte identical; the resulting state is then snapshotted into
    dense tensors on ``device`` and the rounds run batched. The scalar
    engine stays attached as the oracle that membership-event rounds replay
    on.
    """

    def __init__(self, cfg, shards, x_test, y_test, device="cuda"):
        # multi-round windows: run() executes windows of `scan_rounds`
        # rounds as one device program each (0 = one round at a time)
        self.scan_rounds = int(cfg.scan_rounds or 0)
        if self.scan_rounds < 0:
            raise ValueError("scan_rounds must be >= 0")
        self._eval_cadence = max(1, int(cfg.eval_cadence or 1))
        self.device = resolve_device(device)
        self.cfg = cfg
        # device programs (the reference counts its jitted calls the same
        # way): one per window; one round at a time, one per round on the
        # PERFECT path and 2 + buckets on the event path; none for a round
        # replayed on the oracle
        self.device_dispatches = 0
        # captured windows by (W, evaluation pattern), on CUDA, all in one
        # memory pool (replays run one after another on one stream)
        self.graphs: Dict[Tuple[int, Tuple[bool, ...]], WindowGraph] = {}
        self._pool = None
        self._last_accs: np.ndarray | None = None
        # phase timer: assign a telemetry.PhaseTimer to time the round phases
        self.timer = NULL_TIMER
        # exact init state + init-phase traffic via the scalar constructor;
        # the scalar sim stays attached as the churn replay oracle
        seed_sim = IPLSSimulation(cfg, shards, x_test, y_test, device=self.device)
        self._seed = seed_sim
        self.net = seed_sim.net
        # telemetry handoff: this engine emits the seed's stream through the
        # seed's recorder, fed by the control plane / closed-form traffic
        # instead of the pubsub taps, so the tap is detached (the oracle's
        # rounds attach it again, `_device_to_scalar`)
        self.recorder = seed_sim.recorder
        if self.recorder is not None:
            self.timer = seed_sim.timer
            self.net.pubsub.telemetry = None
        self.spec = seed_sim.spec
        self.table = seed_sim.table
        self.layout = seed_sim.layout
        self.history: List[dict] = []
        self._int8 = cfg.wire_dtype == "int8"
        # churn runs the event path too: event rounds replay on the oracle,
        # and only the event path's rings can carry the messages in flight
        # across a boundary (under PERFECT conditions the fate stream gives
        # every message delivered, delay 0)
        self._lossy = (
            cfg.conditions.loss_prob > 0 or cfg.conditions.delay_prob > 0 or self._int8
            or bool(cfg.churn)
        )

        A = cfg.num_agents
        K = self.spec.num_partitions
        sizes = np.asarray(self.spec.sizes, np.int64)
        offsets = np.asarray(self.spec.offsets(), np.int64)
        self.A, self.K, self.N = A, K, self.spec.total
        # membership rows: the live agents in the oracle's `agents` (dict)
        # order, re-read at every re-snapshot; all agents before any churn
        self._ids: List[int] = list(range(A))
        self._row_of = {a: a for a in self._ids}
        self._n_act = A
        self._on_device = True  # the state lives on the device, not the oracle
        self._replay: List[int] = []  # membership-event rounds, ascending
        self._replay_set: frozenset = frozenset()

        # padded instance size: tail zeros flow through the kernels untouched
        # (0 - eps*0), so one shared width serves all partitions. int8 wire:
        # whole quantization blocks, so each (agent, partition) row of the
        # (A, K, S) planes is an integral number of scale blocks; the zero
        # tail quantizes to zero blocks, as the scalar codec's padding does
        self.S = int(sizes.max())
        if self._int8:
            self.S = -(-self.S // BLOCK) * BLOCK
        self._sizes = sizes
        self._offsets = offsets
        # per-partition wire payload bytes: every closed-form byte count
        # below derives from these
        self._wsizes = np.asarray([wire_size(int(s), cfg.wire_dtype) for s in sizes], np.int64)
        self._x_te, self._y_te = seed_sim._x_te, seed_sim._y_te
        if self._lossy:
            self._init_lossy()
            return

        holders, inst_id = self._instance_plane()
        rho, owner_col = self._rho, self._owner_col
        self._bytes_total = self.net.pubsub.total_bytes()
        # message counters mirroring the scalar pubsub (init-phase membership
        # traffic included via the snapshot)
        self.messages_sent = self.net.pubsub.messages_sent
        self.messages_dropped = self.net.pubsub.messages_dropped
        self._set_trainers([seed_sim.trainers[a] for a in range(A)])
        self._eval_idx = np.asarray(eval_subset(list(range(A)), cfg.eval_agents), np.int64)

        # round-0 warm-up traffic (agents fetch partitions absent from both
        # their owned set and the donor caches left behind by joins): one
        # 16-byte fetch and one reply carrying the partition each
        fetch_n = fetch_rep_bytes = 0
        for a in range(A):
            ag = seed_sim.agents[a]
            for k in range(K):
                if k not in ag.owned and k not in ag.cache:
                    fetch_n += 1
                    fetch_rep_bytes += int(self._wsizes[k])
        self._fetch0_n = fetch_n
        self._fetch0_rep_bytes = fetch_rep_bytes

        # steady-state per-round traffic, by channel: every agent sends one
        # UpdateModel per non-owned partition and gets one reply of the same
        # size back; each replica of a rho_k>1 partition publishes once for
        # consensus, fanning out to the rho_k-1 other subscribers
        self._upd_msgs = int(np.sum(A - rho))
        self._upd_bytes = int(np.sum((A - rho) * self._wsizes))
        self._rep_msgs = int(np.sum(np.where(rho > 1, rho, 0)))
        self._rep_bytes = int(np.sum(np.where(rho > 1, rho * self._wsizes, 0)))
        self._rep_deliv = int(np.sum(np.where(rho > 1, rho * (rho - 1), 0)))

        # ---- snapshot values / eps from the scalar init -------------------
        V_pre = np.zeros((self.K_inst, self.S), np.float32)
        eps = np.ones((self.K_inst,), np.float32)
        for k in range(K):
            for j, h in enumerate(holders[k]):
                st = seed_sim.agents[h].owned[k]
                V_pre[inst_id[(k, j)], : sizes[k]] = st.value
                eps[inst_id[(k, j)]] = st.eps

        # ---- per-phase routing tables (period = lcm of replication) -------
        # non-owner a targets H(k)[(round + a) % rho_k]; the pattern repeats
        # with period lcm(rho_k), so all gather index tables are
        # precomputed once
        self._period = int(np.lcm.reduce(rho)) if len(rho) else 1
        agents_arr = np.arange(A)
        t_insts: List[np.ndarray] = []
        contrib_rows: List[List[List[int]]] = []
        R_cap = 1
        for p in range(self._period):
            contrib: List[List[int]] = [[] for _ in range(self.K_inst)]
            t_inst = np.zeros((A, K), np.int64)
            for k in range(K):
                rk = len(holders[k])
                jsel = (p + agents_arr) % rk
                for a in range(A):
                    if owner_col[a, k]:
                        # owners read their OWN replica's post-consensus value:
                        # index into the merged section of the concatenated
                        # [V_pre; V_merged] value table (merged values are
                        # per-instance: the scalar mean starts at the holder's
                        # own value, so at rho >= 3 holders differ by an ULP)
                        t_inst[a, k] = self.K_inst + inst_id[(k, holders[k].index(a))]
                    else:
                        i = inst_id[(k, int(jsel[a]))]
                        t_inst[a, k] = i
                        contrib[i].append(a)
            # owner contributes first (matches scalar pending-row order)
            rows = [[int(self._inst_owner[i])] + contrib[i] for i in range(self.K_inst)]
            R_cap = max(R_cap, max(len(r) for r in rows))
            t_insts.append(t_inst)
            contrib_rows.append(rows)
        self.R_cap = R_cap
        self._t_inst = t_insts
        self._contrib_idx, self._contrib_mask = [], []
        for p in range(self._period):
            idx = np.zeros((self.K_inst, R_cap), np.int64)
            msk = np.zeros((self.K_inst, R_cap), np.float32)
            for i, row in enumerate(contrib_rows[p]):
                idx[i, : len(row)] = row
                msk[i, : len(row)] = 1.0
            self._contrib_idx.append(idx)
            self._contrib_mask.append(msk)

        # ---- replica-merge order: scalar np.mean over [own post-agg value]
        # + arrivals in publish order (holder agent ascending) -------------
        max_rho = int(rho.max()) if len(rho) else 1
        morder = np.zeros((self.K_inst, max_rho), np.int64)
        mmask = np.zeros((self.K_inst, max_rho), bool)
        for k in range(K):
            ids = [inst_id[(k, j)] for j in range(len(holders[k]))]
            by_agent = sorted(ids, key=lambda i: int(self._inst_owner[i]))
            for i in ids:
                row = [i] + [o for o in by_agent if o != i]
                morder[i, : len(row)] = row
                mmask[i, : len(row)] = True

        # ---- device state (updated in place by every round) and constants -
        dev = self.device
        V_pre_t = torch.as_tensor(V_pre, device=dev)
        self._state = {
            "V_pre": V_pre_t,
            "V_merged": V_pre_t.clone(),  # all replicas equal at init
            "eps": torch.as_tensor(eps, device=dev),
        }
        self._last_phase = self._period - 1  # any phase: all replicas equal at init
        self._morder = torch.as_tensor(morder, device=dev)
        self._mmask = torch.as_tensor(mmask, device=dev)
        self._rho_inst = torch.as_tensor(rho[self._inst_k].astype(np.float32), device=dev)
        if self.recorder is not None:
            # the stream carries the scalar engine's eps, a Python float: the
            # recursion is replayed on the host in float64 (the device's
            # float32 one drifts by an ulp); the contributor counts are fixed
            # per routing phase
            self._tel_eps64 = np.asarray(
                [seed_sim.agents[int(self._inst_owner[i])].owned[int(self._inst_k[i])].eps
                 for i in range(self.K_inst)], np.float64)
            self._tel_r = [m.sum(axis=1).astype(np.int64) for m in self._contrib_mask]

    def _instance_plane(self):
        """The instance plane of the current partition table: one row per
        (partition, replica slot), k-major. Owners are kept as agent ids
        (`_inst_owner_id`: fate keys, messages) and as membership rows
        (`_inst_owner`: dense indices and the sort keys of every ordered
        drain, since after churn the oracle's order need not be id order).
        Returns each partition's holders and the (k, slot) -> instance map."""
        K, A = self.K, self.A
        holders: List[List[int]] = [self.table.holders_of(k) for k in range(K)]
        inst_k: List[int] = []
        inst_owner_id: List[int] = []
        inst_id: Dict[Tuple[int, int], int] = {}
        for k in range(K):
            for j, h in enumerate(holders[k]):
                inst_id[(k, j)] = len(inst_k)
                inst_k.append(k)
                inst_owner_id.append(h)
        self.K_inst = len(inst_k)
        self._inst_k = np.asarray(inst_k, np.int64)
        self._inst_owner_id = np.asarray(inst_owner_id, np.int64)
        self._inst_owner = np.asarray([self._row_of[h] for h in inst_owner_id], np.int64)
        rho = np.asarray([len(h) for h in holders], np.int64)
        self._rho = rho
        # (K, max_rho) instance id per (partition, replica slot); -1 pad. A
        # partition has no holder only once every agent is gone
        self._slot_inst = np.full((K, max(1, int(rho.max()))), -1, np.int64)
        for (k, j), i in inst_id.items():
            self._slot_inst[k, j] = i
        # instance rows are k-major: partition k's instances are one row range
        self._inst_rows = [
            (int(np.searchsorted(self._inst_k, k)), int(np.searchsorted(self._inst_k, k, "right")))
            for k in range(K)
        ]
        self._inst_of = {(int(r), k): i for i, (r, k) in enumerate(zip(self._inst_owner, inst_k))}
        owner_col = np.zeros((A, K), bool)
        owner_col[self._inst_owner, self._inst_k] = True
        self._owner_col = owner_col
        return holders, inst_id

    def _set_trainers(self, trainers) -> None:
        """The training rows: their LocalTrainer objects (the scalar
        engine's own, which own the per-agent RNG streams, so drawing batch
        rows through their draw_indices() keeps both engines' SGD inputs
        identical), bucketed by batch size, with their shards on the device
        once: a round's batches are row gathers (`TrainingRows`)."""
        self._rows = TrainingRows(trainers, self.device)

    # -- batched phases ------------------------------------------------------
    def _phase(self, name: str):
        """A timed phase; with a PhaseTimer attached, device work is
        synchronized at its end so it cannot leak into the next phase."""
        return device_phase(self.timer, name, self.device)

    def build_W(self, V_pre, V_merged, t_inst) -> torch.Tensor:
        """Assemble ``len(t_inst)`` agents' flat weights from the concatenated
        value table: owners' t_inst entries point past K_inst into the merged
        section, everyone else's at the pre-merge value of the replica that
        served their UpdateModel reply."""
        V_all = torch.cat([V_pre, V_merged], dim=0)
        return torch.cat(
            [V_all[t_inst[:, k], : int(s)] for k, s in enumerate(self._sizes)], dim=1
        )

    def sgd_all(self, W, Xs, Ys) -> torch.Tensor:
        """All agents' local SGD on the (A, N) weight matrix; Xs/Ys are
        per-bucket stacked batches (a single bucket unless array_split handed
        out shards of two sizes below the batch size)."""
        return self._rows.sgd(W, Xs, Ys, self.cfg.lr, self.cfg.local_iters, self.layout)

    def agg_merge(self, V_merged, eps, W, W2, contrib_idx, contrib_mask):
        """Aggregation + replica consensus, given the pre/post local-SGD
        weight matrices. Returns (V_pre, V_merged, eps) after the round.

        Each instance's contributor deltas are gathered, in the scalar
        oracle's pending order (own push first, then arrivals agent-
        ascending), into one (K_inst, R_cap, S) plane with zero tails; the
        aggregation kernel sums them slot by slot and applies
        ``w - eps*sum`` with one rounding, bit for bit the scalar update."""
        alpha = float(self.cfg.alpha)
        # eps recursion refreshed from r BEFORE applying (paper §2.2), in f32
        # on the device; (1 - alpha) / r is a true divide, as in the reference
        r = contrib_mask.sum(dim=1)
        refreshed = alpha * eps + torch.full_like(eps, 1.0 - alpha) / torch.clamp(r, min=1.0)
        eps_new = torch.where(r > 0, refreshed, eps)
        V_pre = aggregate_batched(V_merged, self._gather_deltas(W - W2, contrib_idx), contrib_mask, eps_new)
        # replica consensus: each instance averages [self] + the other
        # replicas in arrival (holder agent ascending) order, then a true
        # divide by rho — the scalar engine's np.mean associates this way
        acc = V_pre
        for j in range(1, self._morder.shape[1]):
            acc = torch.where(self._mmask[:, j, None], acc + V_pre[self._morder[:, j]], acc)
        return V_pre, acc / self._rho_inst[:, None], eps_new

    def _gather_deltas(self, D, contrib_idx) -> torch.Tensor:
        """The (K_inst, R, S) plane of contributor delta slices, zero tails:
        instance i's slot r holds row ``contrib_idx[i, r]`` of D, restricted
        to partition k(i)'s columns."""
        G = torch.empty(
            (self.K_inst, contrib_idx.shape[1], self.S), dtype=D.dtype, device=D.device
        )
        for k, (lo, hi) in enumerate(self._inst_rows):
            o, sz = int(self._offsets[k]), int(self._sizes[k])
            G[lo:hi, :, :sz] = D[:, o : o + sz][contrib_idx[lo:hi]]
            G[lo:hi, :, sz:] = 0.0
        return G

    def eval_rows(self, V_pre, V_merged, t_eval) -> torch.Tensor:
        """Accuracy of the sub-sampled agents: their assembled rows only, so
        the full (A, N) matrix is never evaluated."""
        W_eval = self.build_W(V_pre, V_merged, t_eval)
        return mlp_mnist.evaluate(unflatten_params(W_eval, self.layout), self._x_te, self._y_te)

    # -- one round of device work -------------------------------------------
    def _batch_rows(self) -> Dict[str, np.ndarray]:
        """This round's batch rows into the device-resident shards, one
        (A_b, bs_b) array per bucket, drawn through every training row's
        RNG stream in row order (only online agents train: the scalar round
        skips offline ones, so their streams do not advance)."""
        return {f"bidx{b}": idx for b, idx in enumerate(self._rows.draw_indices())}

    def _batches(self, x):
        """The round's stacked batches per bucket, gathered on the device."""
        return self._rows.gather([x[f"bidx{b}"] for b in range(len(self._rows.buckets))])

    def _round(self, st, x, do_eval: bool, acc_out, met_out, ph) -> None:
        """One round of device work: read one round's staged inputs ``x``,
        update the device state ``st`` in place, write the evaluated agents'
        accuracies into ``acc_out`` (NaN where ``do_eval`` is False) and,
        with telemetry on, the round's (delta_normsq, value_normsq) into the
        (2,) ``met_out`` (None with telemetry off: the round then runs
        exactly the kernels it runs without telemetry). Nothing here reads
        device data back to the host, so a window of these can be captured
        into one CUDA graph. ``ph`` names the timed phases."""
        if self._lossy:
            accs = self._round_event(st, x, do_eval, met_out, ph)
        else:
            accs = self._round_perfect(st, x, do_eval, met_out, ph)
        if accs is None:
            acc_out.fill_(float("nan"))
        else:
            acc_out.copy_(accs)

    def _round_perfect(self, st, x, do_eval, met_out, ph):
        with ph("build_w"):
            W = self.build_W(st["V_pre"], st["V_merged"], x["t_prev"])
        with ph("sgd"):
            W2 = self.sgd_all(W, *self._batches(x))
        with ph("aggregate"):
            V_pre, V_merged, eps = self.agg_merge(
                st["V_merged"], st["eps"], W, W2, x["idx"], x["mask"]
            )
            if met_out is not None:
                # every agent's delta and the post-merge value plane
                met_out.copy_(metric_pair(W - W2, V_merged))
            del W, W2
            st["V_pre"].copy_(V_pre)
            st["V_merged"].copy_(V_merged)
            st["eps"].copy_(eps)
        if not do_eval:
            return None
        with ph("eval"):
            return self.eval_rows(st["V_pre"], st["V_merged"], x["t_eval"])

    def _round_event(self, st, x, do_eval, met_out, ph):
        with ph("device_pre"):
            Vstart_new, W = self._pre(st, x)
        with ph("device_sgd"):
            D = W - self.sgd_all(W, *self._batches(x))
        del W
        with ph("device_core"):
            accs = self._core(st, D, Vstart_new, x, do_eval)
            if met_out is not None:
                # the trained rows' raw (pre-quantize) deltas, as the scalar
                # engine stacks them, and the post-merge value plane
                met_out.copy_(metric_pair(D, st["V"]))
        return accs

    def _perfect_inputs(self, rnd: int) -> Dict[str, np.ndarray]:
        """Round ``rnd``'s routing tables on the PERFECT path: weights are
        assembled with the previous round's routing, contributions and
        evaluation use this round's."""
        p = rnd % self._period
        x = dict(
            t_prev=self._t_inst[self._last_phase], idx=self._contrib_idx[p],
            mask=self._contrib_mask[p], t_eval=self._t_inst[p][self._eval_idx],
        )
        self._last_phase = p
        return x

    def _do_eval(self, rnd: int) -> bool:
        """Windowed-mode evaluation gate: every `eval_cadence`-th round plus
        the final round of the run."""
        return (rnd + 1) % self._eval_cadence == 0 or rnd == self.cfg.rounds - 1

    def _run(self, r0: int, W: int, windowed: bool):
        """Rounds r0 .. r0+W-1: their host work up front, then their device
        rounds, as one window (one CUDA-graph replay on the card) or as one
        round run eagerly (W = 1). Returns the (W, E) accuracies, the (W, 2)
        norm metrics (None with telemetry off) and, on the event path, each
        round's (msgs, drops, nbytes) and its telemetry snapshot (see
        `_control_round`)."""
        rounds = range(r0, r0 + W)
        counts = snaps = None
        if self._lossy:
            with self._phase("fate_draw"):
                wf = _FateWindow(
                    self._fates, self._t, W, self._ids_col, np.arange(self.K)[None, :],
                    self._rep_src_agent, self._rep_k, self._rep_dst_agent,
                )
            with self._phase("control"):
                xs, counts, snaps = zip(*[self._control_round(r, wf) for r in rounds])
        else:
            xs = [self._perfect_inputs(r) for r in rounds]
        with self._phase("batches"):
            for x in xs:
                x.update(self._batch_rows())
        host = {k: np.stack([x[k] for x in xs]) for k in xs[0]}
        if windowed:
            accs, mets = self._device_window(host, tuple(self._do_eval(r) for r in rounds))
            self.device_dispatches += 1
        else:
            accs, mets = self._device_rounds(host, (True,), self._phase)
            self.device_dispatches += 2 + len(self._rows.buckets) if self._lossy else 1
        return accs, mets, counts, snaps

    def _run_perfect(self, r0: int, W: int, windowed: bool) -> None:
        accs, mets, _, _ = self._run(r0, W, windowed)
        for w in range(W):
            self._perfect_traffic(r0 + w)
            self.history.append(self._metrics_entry(r0 + w, accs[w]))
            if self.recorder is not None:
                self._emit_perfect(r0 + w, mets[w])

    def _run_round_lossy(self, rnd: int) -> None:
        accs, mets, ((msgs, drops, nbytes),), (snap,) = self._run(rnd, 1, windowed=False)
        self.messages_sent += msgs
        self.messages_dropped += drops
        self._bytes_total += nbytes
        self.history.append(self._metrics_entry(rnd, accs[0]))
        if self.recorder is not None:
            self._emit_row(rnd, *snap, mets[0])

    def _run_window_lossy(self, r0: int, W: int) -> None:
        accs, mets, counts, snaps = self._run(r0, W, windowed=True)
        for w, (msgs, drops, nbytes) in enumerate(counts):
            self.messages_sent += msgs
            self.messages_dropped += drops
            self._bytes_total += nbytes
            self.history.append(self._metrics_entry(r0 + w, accs[w]))
            if self.recorder is not None:
                self._emit_row(r0 + w, *snaps[w], mets[w])

    def _device_outputs(self, W: int):
        """Fresh (W, E) accuracy and (W, 2) norm-metric outputs (the latter
        None with telemetry off)."""
        dev = self.device
        accs = torch.empty((W, len(self._eval_idx)), dtype=torch.float32, device=dev)
        mets = None
        if self.recorder is not None:
            mets = torch.empty((W, 2), dtype=torch.float32, device=dev)
        return accs, mets

    @staticmethod
    def _host(accs, mets):
        return accs.cpu().numpy(), None if mets is None else mets.cpu().numpy()

    def _device_rounds(self, host, des, ph):
        """The device rounds of ``host``'s staged inputs run eagerly, one
        after another; returns the (W, E) accuracies and (W, 2) metrics."""
        inp = {k: torch.as_tensor(v, device=self.device) for k, v in host.items()}
        accs, mets = self._device_outputs(len(des))
        for w, de in enumerate(des):
            self._round(self._state, {k: v[w] for k, v in inp.items()}, de, accs[w],
                        None if mets is None else mets[w], ph)
        return self._host(accs, mets)

    def _device_window(self, host, des):
        """A window's device rounds: on the CPU a plain loop; on CUDA one
        replay of the window's graph, captured at the first window of its
        (W, evaluation pattern). A graph that cannot be captured raises:
        nothing falls back to the eager loop."""
        if self.device.type != "cuda":
            with self._phase("device_window"):
                return self._device_rounds(host, des, NULL_TIMER.phase)
        key = (len(des), des)
        g = self.graphs.get(key)
        if g is None:
            with self._phase("graph_capture"):
                g = self.graphs[key] = self._capture(host, des)
        else:
            for k, buf in g.inputs.items():
                buf.copy_(torch.from_numpy(host[k]))
        with self._phase("device_window"):
            g.graph.replay()
            return self._host(g.accs, g.mets)

    def _capture(self, host, des) -> WindowGraph:
        """Capture a window's device rounds into one CUDA graph over static
        buffers: the state tensors (updated in place), the staged inputs
        (holding this window's values) and the accuracy output. One eager
        round on a copy of the state runs first, on the current stream (not
        the capturing one): it builds the kernels and lets cuBLAS and
        autograd set up, and its kernel launches are real ones. It takes no
        side stream of its own: PyTorch keeps a cuBLAS workspace (64 MiB on
        an H100) for every stream that runs a product and never frees it, so
        a stream per engine left one behind for every simulation. The
        kernels the capture records are counted at every replay
        (`kernels._build.Graph`)."""
        dev = self.device
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        accs, mets = self._device_outputs(len(des))
        scratch = {k: v.clone() for k, v in self._state.items()}
        x0 = {k: v[0] for k, v in inputs.items()}
        self._round(scratch, x0, True, torch.empty_like(accs[0]),
                    None if mets is None else torch.empty_like(mets[0]), NULL_TIMER.phase)
        del scratch, x0
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = Graph()
        with graph.capture(pool=self._pool):
            for w, de in enumerate(des):
                x = {k: v[w] for k, v in inputs.items()}
                self._round(self._state, x, de, accs[w], None if mets is None else mets[w],
                            NULL_TIMER.phase)
        return WindowGraph(graph, inputs, accs, mets)

    def run_round(self, rnd: int) -> dict:
        if not self._lossy:
            self._run_perfect(rnd, 1, windowed=False)
        elif rnd in self._replay_set or not (self._on_device or self._scalar_to_device(rnd)):
            # a membership event, or a span that cannot start yet (no agent
            # online, a harvest deferred): the round replays on the oracle
            return self._scalar_round(rnd)
        else:
            self._run_round_lossy(rnd)
        return self.history[-1]

    def run_window(self, start_rnd: int, window: int) -> List[dict]:
        """Run ``window`` consecutive rounds as ONE device program (one
        CUDA-graph replay on the card). Returns the new history entries, one
        per round, traffic counted per round exactly as the scalar pubsub
        would. A window never spans a membership event: one that would, or
        whose span cannot start yet, runs round at a time instead."""
        if window < 1:
            raise ValueError("window must be >= 1")
        n0 = len(self.history)
        rounds = range(start_rnd, start_rnd + window)
        if not self._lossy:
            self._run_perfect(start_rnd, window, windowed=True)
        elif any(r in self._replay_set for r in rounds) or not (
            self._on_device or self._scalar_to_device(start_rnd)
        ):
            for r in rounds:
                self.run_round(r)
        else:
            self._run_window_lossy(start_rnd, window)
        return self.history[n0:]

    def run(self) -> List[dict]:
        """Every round of the run: one at a time, or in windows of
        `scan_rounds` clipped at the next membership-event round, which
        replays on the oracle."""
        W, R = self.scan_rounds, self.cfg.rounds
        rnd = 0
        while rnd < R:
            if not W or rnd in self._replay_set:
                self.run_round(rnd)
                rnd += 1
                continue
            nxt = next((r for r in self._replay if r > rnd), R)
            step = min(W, nxt - rnd)
            self.run_window(rnd, step)
            rnd += step
        return self.history

    def _perfect_traffic(self, rnd: int) -> None:
        # keep the pubsub-mirroring counters live (nothing drops under
        # PERFECT conditions)
        self._bytes_total += 2 * self._upd_bytes + self._rep_bytes
        self.messages_sent += 2 * self._upd_msgs + self._rep_msgs
        if rnd == 0:
            self._bytes_total += 16 * self._fetch0_n + self._fetch0_rep_bytes
            self.messages_sent += 2 * self._fetch0_n

    def _metrics_entry(self, rnd: int, accs: np.ndarray) -> dict:
        """History entry for one round; rounds a window did not evaluate
        (NaN accuracies, eval_cadence > 1) reuse the last computed
        accuracies (zeros before the first), so the history schema never
        changes; the round's telemetry row carries the same ones."""
        if np.isnan(accs).all():
            if self._last_accs is None:
                self._last_accs = np.zeros_like(accs)
            accs = self._last_accs
        else:
            self._last_accs = accs
        return {
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std()),
            "acc_max": float(accs.max()),
            "round": rnd,
            "active": self._n_act,
            "bytes_total": self._bytes_total,
        }

    # -- telemetry emission --------------------------------------------------
    def _emit_row(self, rnd: int, contrib, eps, met) -> None:
        """The engine's one emission site: one schema-ordered finish_round
        per round, from the device's norm metrics and the control plane's
        snapshots, after `_metrics_entry` (skipped rounds carry the reused
        accuracies). Values and float paths are the scalar engine's, so the
        rows are byte for byte the same."""
        m = np.asarray(met, np.float32)
        self.recorder.finish_round(
            round=rnd,
            active=self._n_act,
            contrib=[int(x) for x in contrib],
            eps=[float(x) for x in eps],
            delta_normsq=float(m[0]),
            value_normsq=float(m[1]),
            accs=self._last_accs,
            bytes_total=self._bytes_total,
            msgs_total=self.messages_sent,
            drops_total=self.messages_dropped,
        )

    def _emit_perfect(self, rnd: int, met) -> None:
        """PERFECT-path telemetry: the closed-form traffic split by channel
        (everything delivered at delay 0; replica publishes fan out rho_k-1
        ways), then the host float64 replay of the scalar eps recursion."""
        rec = self.recorder
        if rnd == 0 and self._fetch0_n:
            n = self._fetch0_n
            rec.on_channel(rnd, "fetch", n, 16 * n, 0)
            rec.on_delivered(rnd, 0, n)
            rec.on_channel(rnd, "fetch_reply", n, self._fetch0_rep_bytes, 0)
            rec.on_delivered(rnd, 0, n)
        rec.on_channel(rnd, "update", self._upd_msgs, self._upd_bytes, 0)
        rec.on_delivered(rnd, 0, self._upd_msgs)
        rec.on_channel(rnd, "update_reply", self._upd_msgs, self._upd_bytes, 0)
        rec.on_delivered(rnd, 0, self._upd_msgs)
        if self._rep_msgs:
            rec.on_channel(rnd, "replica", self._rep_msgs, self._rep_bytes, 0)
            rec.on_delivered(rnd, 0, self._rep_deliv)
        r = self._tel_r[rnd % self._period]
        alpha = self.cfg.alpha
        self._tel_eps64 = alpha * self._tel_eps64 + (1.0 - alpha) / r
        self._emit_row(rnd, r, self._tel_eps64, met)

    # ===================== event-driven path (LOSSY / int8) ================
    def _init_lossy(self) -> None:
        """State for the event-driven path: the fate stream, the event-ring
        depth, the membership-event rounds, and the dense snapshot of the
        scalar init state. Only membership-independent constants live here;
        everything shaped by the membership is built by
        `_snapshot_from_scalar`, which runs again at every span boundary."""
        cfg = self.cfg
        cond = cfg.conditions
        seed_sim = self._seed
        # delays are in tick units; a message delayed d ticks lands
        # ceil(d / TICKS) rounds late at its drain point
        self._Lu = -(-cond.max_delay_rounds // TICKS_PER_ROUND) if cond.delay_prob > 0 else 0
        # depth of the value-history rings (value ages 0..Lu) and of the
        # in-flight event rings, indexed by (consuming round) mod depth:
        # nothing stays in flight longer than Lu rounds (delays are capped),
        # and every slot drains once per depth
        self._HD = self._Lu + 1
        # int8 and churn run this path under PERFECT conditions too; the
        # scalar engine installed no fate stream there, so build one — every
        # draw then degenerates to (delivered, delay 0), i.e. default delivery
        self._fates = seed_sim.fates or MessageFates(cond, cfg.seed)
        # membership-event rounds replay on the scalar oracle
        self._replay = sorted({int(r) for r in (cfg.churn or {}) if 0 <= int(r) < cfg.rounds})
        self._replay_set = frozenset(self._replay)
        # delivered-fate messages harvested at a boundary whose recipient is
        # offline: they drop at their delivery tick (keyed by its round)
        self._pending_drop_msgs: Dict[int, list] = {}
        # harvested in-flight replica values awaiting a version-filtered
        # merge, keyed by their merge round
        self._mail_merges: Dict[int, list] = {}
        # the constructor's membership broadcasts are still in flight; the
        # scalar ticks would deliver them during round 0, so deliver them
        # inert now (a later oracle round would otherwise deliver them again,
        # and drop any addressed to an agent then offline)
        ps = seed_sim.net.pubsub
        for _i, msg in sorted(enumerate(ps._inflight), key=lambda e: (e[1].deliver_round, e[0])):
            ps._inbox[msg.recipient].append(msg)
            ps.bytes_recv[msg.recipient] += msg.nbytes
        ps._inflight = []
        self._snapshot_from_scalar(0, harvest=False)

    def _snapshot_from_scalar(self, r0: int, harvest: bool) -> None:
        """Build the dense state of the event-driven path from the oracle's
        state at the start of round r0: rows, the instance plane, send
        masks, replica pair tables, the value/eps/version/cache/residual
        planes, the rings, the training rows and their shards, the
        evaluated rows. Runs at construction (harvest=False: the
        constructor's membership broadcasts were delivered inert) and at the
        start of each span after an oracle round (harvest=True: the oracle's
        in-flight messages move into the rings and the span's mail plane,
        `_harvest_pubsub`). The graphs captured in the previous span replay
        into that span's state tensors, whose shapes and addresses this
        changes: they go first, and with them their memory pool."""
        self.graphs, self._pool = {}, None
        self._state, self._rows = {}, None
        sim = self._seed
        ps = sim.net.pubsub
        cfg = self.cfg
        K, S, N, HD, Lu = self.K, self.S, self.N, self._HD, self._Lu
        sizes = self._sizes

        # ---- membership rows: live agents in the oracle's (dict) order ----
        self._ids = [a for a, ag in sim.agents.items() if ag.live]
        A = self.A = len(self._ids)
        self._row_of = {a: r for r, a in enumerate(self._ids)}
        self._ids_arr = np.asarray(self._ids, np.int64)
        self._ids_col = self._ids_arr[:, None]
        act = np.asarray([not ps.is_offline(a) for a in self._ids], bool)
        self._act = act
        self._act_idx = np.nonzero(act)[0]
        self._n_act = int(act.sum())
        self._full_active = bool(act.all())
        self._instance_plane()
        K_inst, rho, owner_col = self.K_inst, self._rho, self._owner_col

        # sequential-reduction capacities: each other replica of a partition
        # has at most one value in flight per send round (ages 0..Lu, the
        # harvested ones included); each non-owner at most one delta per
        # in-flight send round. The quantized kernel takes the owner's raw
        # delta through its own input, so its contributor table holds only
        # the remote (wire) rows; the f32 table holds the owner first
        self._mw = max(1, (self._slot_inst.shape[1] - 1) * HD)
        self.R_cap = max(1, (A - 1) * HD) if self._int8 else 1 + (A - 1) * HD

        # per-round UpdateModel sends are closed-form over ONLINE senders:
        # loss only affects delivery, never whether a message is sent, and
        # offline agents send nothing (the scalar round skips them)
        self._upd_send_mask = act[:, None] & ~owner_col & (rho > 0)[None, :]
        self._upd_msgs = int(self._upd_send_mask.sum())
        self._upd_bytes = int((self._upd_send_mask * self._wsizes[None, :]).sum())
        # ordered (source -> destination) instance pairs for replica sync.
        # Sources are instances whose owner is online (offline holders skip
        # sync_replicas); destinations include offline holders: the pubsub
        # fans a publish out to every subscriber, a fate each, and a
        # delivered fate to an offline holder is dropped at the send tick
        src, dst = [], []
        for lo, hi in self._inst_rows:
            for i in range(lo, hi):
                if act[self._inst_owner[i]]:
                    src += [i] * (hi - lo - 1)
                    dst += [j for j in range(lo, hi) if j != i]
        self._rep_src = np.asarray(src, np.int64)
        self._rep_dst = np.asarray(dst, np.int64)
        self._rep_src_agent = self._inst_owner_id[self._rep_src]
        self._rep_dst_agent = self._inst_owner_id[self._rep_dst]
        self._rep_k = self._inst_k[self._rep_src]
        self._rep_dst_act = act[self._inst_owner[self._rep_dst]]
        pub_inst = sorted(set(src))
        self._pub_msgs = len(pub_inst)
        self._pub_bytes = int(np.sum(self._wsizes[self._inst_k[pub_inst]])) if pub_inst else 0

        # ---- value / eps / version / cache / residual planes --------------
        V = np.zeros((K_inst, S), np.float32)
        # eps lives on the HOST in float64: the scalar engine's eps is a
        # python float, and its recursion must be replayed in the same
        # precision (an f32 replay drifts by an ULP, which the int8 codec
        # amplifies to a full quantization step)
        eps64 = np.ones(K_inst, np.float64)
        ver = np.zeros(K_inst, np.int64)
        for i in range(K_inst):
            st = sim.agents[int(self._inst_owner_id[i])].owned[int(self._inst_k[i])]
            V[i, : sizes[self._inst_k[i]]] = st.value
            eps64[i] = st.eps
            ver[i] = st.version
        self._eps64, self._ver = eps64, ver
        # explicit cache plane + fetch warm-up state: a slot stays at its
        # last successfully delivered value (the scalar cache staleness)
        C = np.zeros((A, K, S), np.float32)
        has = np.zeros((A, K), bool)
        for r, a in enumerate(self._ids):
            for k, val in sim.agents[a].cache.items():
                C[r, k, : sizes[k]] = val
                has[r, k] = True
        self._has_cache = has
        if self._int8:
            # error-feedback residuals, one per (sender, partition) wire
            # slice. Owner positions keep the agent's residual from any send
            # before it owned the partition (frozen, never read again), as
            # the scalar _delta_err dict keeps stale entries across handoffs
            E = np.zeros((A, K, S), np.float32)
            for r, a in enumerate(self._ids):
                for k, err in sim.agents[a]._delta_err.items():
                    if err is not None:
                        E[r, k, : len(err)] = err
            # delta ring of in-flight windows, one entry per delay age: the
            # int8 codes and per-block scales, dequantized inside the kernel
            ring_np = (np.zeros((Lu, A, K, S), np.int8),
                       np.zeros((Lu, A, K, S // BLOCK), np.float32))
        else:
            ring_np = np.zeros((Lu, A, N), np.float32)
        self._serve_ring: List[list] = [[] for _ in range(HD)]
        self._arr_ring: List[list] = [[] for _ in range(HD)]
        self._cache_ring: List[list] = [[] for _ in range(HD)]
        self._merge_ring: List[list] = [[] for _ in range(HD)]
        self._seq = 0
        self._t = r0  # the next round the control plane runs
        self._pending_drop_msgs, self._mail_merges = {}, {}
        mail_vals: List[np.ndarray] = []
        if harvest:
            # may raise _HarvestDeferred; the pubsub changes commit at the
            # end of the harvest, so a raise leaves the pubsub intact
            self._harvest_pubsub(r0, ring_np, mail_vals)

        # ---- device state, updated in place by every round ----------------
        dev = self.device
        self._state = {
            "V": torch.as_tensor(V, device=dev),
            "C": torch.as_tensor(C, device=dev),
            "Vagg_hist": torch.zeros((HD, K_inst, S), dtype=torch.float32, device=dev),
            "Vstart_hist": torch.zeros((HD, K_inst, S), dtype=torch.float32, device=dev),
        }
        if self._int8:
            self._state["E"] = torch.as_tensor(E, device=dev)
            self._state["ring_q"] = torch.as_tensor(ring_np[0], device=dev)
            self._state["ring_s"] = torch.as_tensor(ring_np[1], device=dev)
        else:
            self._state["ring"] = torch.as_tensor(ring_np, device=dev)
        # span-constant mail plane: the wire images of harvested in-flight
        # reply and replica payloads, read by _KIND_MAIL cache writes and
        # mail merges (the span's value-history rings start empty, so values
        # from before the span travel beside them); a fixed-address input of
        # the span's graphs. None without mail: the span then runs exactly
        # the ops of a churn-free run
        self._mail = torch.as_tensor(np.stack(mail_vals), device=dev) if mail_vals else None

        # ---- training rows, evaluated rows, device constants --------------
        self._set_trainers([sim.trainers[self._ids[r]] for r in self._act_idx])
        self._eval_idx = np.asarray(
            [self._row_of[a] for a in eval_subset(list(self._ids), cfg.eval_agents)], np.int64
        )
        self._own_a = torch.as_tensor(self._inst_owner, device=dev)
        self._own_k = torch.as_tensor(self._inst_k, device=dev)
        self._own_k_col = self._own_k[:, None]
        self._ones_inst = torch.ones(K_inst, dtype=torch.float32, device=dev)
        # SGD runs on the online rows only: their weights are assembled
        # (owners read their instance value, everyone else their cache row;
        # per partition, the positions of its owners among the assembled
        # rows and their instance ids), and their deltas are scattered back
        # into the (A, N) plane with offline rows zero. With every agent
        # online both stay the identity (None), so a churn-free span runs
        # exactly the ops it ran before
        self._act_rows = None if self._full_active else torch.as_tensor(self._act_idx, device=dev)
        self._off3 = None if self._full_active else torch.as_tensor(~act, device=dev)[:, None, None]
        self._fill_act = self._owner_fill(self._act_idx)
        self._eval_rows = torch.as_tensor(self._eval_idx, device=dev)
        self._fill_eval = self._owner_fill(self._eval_idx)
        self.messages_sent = ps.messages_sent
        self.messages_dropped = ps.messages_dropped
        self._bytes_total = ps.total_bytes()
        # the span's rounds feed the recorder from the control plane
        ps.telemetry = None
        if harvest and self._eval_cadence > 1:
            # windowed rounds that skip evaluation reuse the last computed
            # accuracies: those of the oracle's round, so the reuse crosses
            # the boundary intact
            self._last_accs = np.asarray(sim._eval_accs(), np.float32)

    def _harvest_pubsub(self, r0: int, ring_np, mail_vals: List[np.ndarray]) -> None:
        """Move the oracle pubsub's delivered-but-undrained inbox messages
        and its in-flight queue into span state: UpdateModel payloads into
        the delta ring + arrival entries, fetches into serve entries,
        reply and replica values into the mail plane, membership traffic
        delivered inert, and delivered-fate messages to offline recipients
        into drops at their delivery tick.

        Classification is read-only; the pubsub changes commit at the end,
        so `_HarvestDeferred` (only when max_delay_rounds > TICKS_PER_ROUND)
        leaves the pubsub untouched for the oracle's retry round. Within one
        drain slot, harvested inbox entries precede in-flight entries in
        delivery order: the inbox fill order for max_delay_rounds <=
        TICKS_PER_ROUND (beyond that, stragglers from different source rounds
        may interleave with in-span arrivals in send order)."""
        sim = self._seed
        ps = sim.net.pubsub
        TICKS = TICKS_PER_ROUND
        wire = sim.wire
        sizes, offsets = self._sizes, self._offsets
        row_of, act, inst_of = self._row_of, self._act, self._inst_of
        Lu, HD = self._Lu, self._HD

        arr_items: list = []  # (deliver tick, order, drain round, entry)
        serve_items: list = []
        new_inboxes: Dict[int, list] = {}
        deliveries: list = []  # messages delivered whole (dead recipient / membership)

        def active_row(aid):
            r = row_of.get(aid)
            return r if (r is not None and act[r]) else None

        def pad_val(wp):
            val = np.zeros(self.S, np.float32)
            dec = wire.decode(wp)
            val[: len(dec)] = dec
            return val

        def ring_write(age, a_row, k, wp):
            if not 0 <= age < Lu:
                raise _HarvestDeferred
            if self._int8:
                # the codes and scales ride the ring verbatim
                q, sc = wp
                ring_np[0][age, a_row, k, : len(q)] = q
                ring_np[1][age, a_row, k, : len(sc)] = sc
            else:
                ring_np[age, a_row, offsets[k] : offsets[k] + sizes[k]] = wire.decode(wp)

        def take_update(msg, order, u):
            k, wp = msg.payload
            i = inst_of.get((row_of[msg.recipient], int(k)))
            if i is None:
                return  # the recipient no longer owns k: scalar collect drops it
            a_row = active_row(msg.sender)
            if a_row is None:
                raise _HarvestDeferred  # the sender left or went offline mid-flight
            send_r = msg.sent_round // TICKS
            ring_write(r0 - send_r - 1, a_row, int(k), wp)
            arr_items.append((msg.deliver_round, order, u, (send_r, a_row, int(k), i)))

        def take_fetch(msg, order, u):
            a_row = active_row(msg.sender)
            if a_row is None:
                raise _HarvestDeferred  # the requester left or went offline mid-flight
            (k,) = msg.payload
            i = inst_of.get((row_of[msg.recipient], int(k)))
            if i is None:
                return  # the holder lost k: scalar serve_reply returns silently
            serve_items.append(
                (msg.deliver_round, order, u, (msg.sent_round // TICKS, a_row, int(k), i))
            )

        def take_reply(msg):
            h_row = row_of.get(msg.sender)
            if h_row is None:
                raise _HarvestDeferred  # the serving holder left mid-flight
            k, wp = msg.payload
            dv = max(msg.deliver_round, TICKS * r0)
            self._cache_ring[(dv // TICKS) % HD].append(
                (dv, msg.sent_round, h_row, self._seq, row_of[msg.recipient], int(k),
                 _KIND_MAIL, r0, len(mail_vals))
            )
            self._seq += 1
            mail_vals.append(pad_val(wp))

        def take_replica(msg):
            s_row = row_of.get(msg.sender)
            if s_row is None:
                raise _HarvestDeferred  # the publishing holder left mid-flight
            k, wp, ver = msg.payload
            di = inst_of.get((row_of[msg.recipient], int(k)))
            if di is None:
                return  # no longer an owner: the scalar merge filter drops it
            dv = max(msg.deliver_round, TICKS * r0)
            self._mail_merges.setdefault(dv // TICKS, []).append(
                (dv - 1, s_row, int(ver), di, len(mail_vals), msg.sent_round)
            )
            mail_vals.append(pad_val(wp))

        def take(msg, order, u):
            if msg.topic == UPDATE_TOPIC:
                take_update(msg, order, u)
            elif msg.topic == FETCH_TOPIC:
                take_fetch(msg, order, u)
            elif msg.topic == REPLY_TOPIC:
                take_reply(msg)
            elif msg.topic.startswith(REPLICA_TOPIC):
                take_replica(msg)
            else:
                return False  # membership traffic: inert
            return True

        # -- delivered-but-undrained inboxes of online agents. Offline
        # agents' inboxes stay in the pubsub untouched: the scalar engine
        # does not drain them either until they come back online, itself a
        # membership event that replays on the oracle
        order = 0
        for r, aid in enumerate(self._ids):
            if act[r]:
                keep = []
                for msg in ps._inbox.get(aid, []):
                    order += 1
                    if not take(msg, order, r0):
                        keep.append(msg)
                new_inboxes[aid] = keep

        # -- in-flight messages, in delivery order (ties broken by queue
        # position: the order the scalar tick appends them to an inbox)
        for _idx, msg in sorted(enumerate(ps._inflight), key=lambda e: (e[1].deliver_round, e[0])):
            order += 1
            rrow = row_of.get(msg.recipient)
            if rrow is None:
                deliveries.append(msg)  # dead recipient: into its never-drained inbox
            elif not act[rrow]:
                # delivered fate, offline recipient: the scalar tick drops it
                # at its delivery tick
                self._pending_drop_msgs.setdefault(msg.deliver_round // TICKS, []).append(msg)
            else:
                lat = -(-(msg.deliver_round - msg.sent_round) // TICKS)
                if not take(msg, order, msg.sent_round // TICKS + lat):
                    deliveries.append(msg)  # membership traffic: delivered inert

        # -- commit (nothing raises past this point) ------------------------
        for aid, keep in new_inboxes.items():
            ps._inbox[aid] = keep
        for msg in deliveries:
            ps._inbox[msg.recipient].append(msg)
            ps.bytes_recv[msg.recipient] += msg.nbytes
        ps._inflight = []
        for _dv, _o, u, entry in sorted(serve_items, key=lambda e: (e[0], e[1])):
            self._serve_ring[u % HD].append(entry)
        for _dv, _o, u, entry in sorted(arr_items, key=lambda e: (e[0], e[1])):
            self._arr_ring[u % HD].append(entry)

    def _has_active(self) -> bool:
        ps = self.net.pubsub
        return any(ag.live and not ps.is_offline(a) for a, ag in self._seed.agents.items())

    def _scalar_to_device(self, r0: int) -> bool:
        """Enter a span at round r0: snapshot + harvest from the oracle.
        Returns False (the round stays on the oracle) when no agent is
        online or a straggler defers the harvest."""
        if not self._has_active():
            return False
        try:
            with self._phase("snapshot"):
                self._snapshot_from_scalar(r0, harvest=True)
        except _HarvestDeferred:
            return False
        self._on_device = True
        return True

    def _device_to_scalar(self, rnd: int) -> None:
        """Leave the span before replaying round ``rnd`` on the oracle: write
        the device planes back into the scalar agents (`import_state`) and
        re-inject every queued ring and mail entry as a pubsub message, in
        send order, so the oracle resumes from exactly the state the span
        produced."""
        sim = self._seed
        ps = sim.net.pubsub
        TICKS = TICKS_PER_ROUND
        wire = sim.wire
        sizes, offsets, wsizes = self._sizes, self._offsets, self._wsizes
        st = {k: v.cpu().numpy() for k, v in self._state.items()}
        Vl, Cpl, Vagg, Vstart = st["V"], st["C"], st["Vagg_hist"], st["Vstart_hist"]
        mail = None if self._mail is None else self._mail.cpu().numpy()

        # ---- protocol state ----------------------------------------------
        for r, aid in enumerate(self._ids):
            owned = {
                k: (Vl[i, : sizes[k]], self._eps64[i], self._ver[i])
                for k in range(self.K)
                if (i := self._inst_of.get((r, k))) is not None
            }
            cache = {k: Cpl[r, k, : sizes[k]] for k in range(self.K) if self._has_cache[r, k]}
            derr = {k: st["E"][r, k, : sizes[k]] for k in range(self.K)} if self._int8 else None
            sim.agents[aid].import_state(owned, cache, derr)

        # ---- pubsub clock, counters, telemetry tap ------------------------
        ps.round = TICKS * rnd
        ps.messages_sent = self.messages_sent
        ps.messages_dropped = self.messages_dropped
        delta_b = self._bytes_total - ps.total_bytes()
        if delta_b:
            # the span counts traffic in aggregate; only the total is
            # observable (total_bytes sums the per-sender dict)
            ps.bytes_sent[self._ids[0]] += delta_b
        # the oracle's rounds tap the pubsub and emit through the oracle's
        # own `_tel_finish`, into the same recorder
        ps.telemetry = self.recorder

        # ---- queued entries back into the pubsub as messages --------------
        # sort key = (send tick, phase rank, the scalar within-tick order):
        # _inflight holds messages in send order, so the tick scan delivers
        # same-tick arrivals exactly as the scalar rounds would
        f = self._fates
        ids, owner_id = self._ids_arr, self._inst_owner_id
        out = []  # (sort key, message)

        def put(key, topic, sender, payload, sent, due, nbytes, recipient):
            out.append((key, Message(topic, int(sender), payload, sent, due, int(nbytes),
                                     int(recipient))))

        def value(img):  # a value payload: what encode_value puts on the wire
            return wire.encode_value(img)[0]

        for s in range(self._HD):
            for send_r, a, k, inst in self._serve_ring[s]:
                _de, d = f.draw_one(CH_FETCH, send_r, int(ids[a]), k)
                t0 = TICKS * send_r
                put((t0, 0, a, k), FETCH_TOPIC, ids[a], (k,), t0, t0 + d, 16, owner_id[inst])
            for send_r, a, k, inst in self._arr_ring[s]:
                _de, d = f.draw_one(CH_UPDATE, send_r, int(ids[a]), k)
                t0 = TICKS * send_r + 2
                age = rnd - send_r - 1
                if self._int8:
                    # the ring's codes and scales go back verbatim: bitwise,
                    # no decode and re-encode
                    nb = -(-int(sizes[k]) // BLOCK)
                    payload = (st["ring_q"][age, a, k, : sizes[k]].copy(),
                               st["ring_s"][age, a, k, :nb].copy())
                else:
                    payload = value(st["ring"][age, a, offsets[k] : offsets[k] + sizes[k]])
                put((t0, 1, a, k), UPDATE_TOPIC, ids[a], (k, payload), t0, t0 + d, wsizes[k],
                    owner_id[inst])
            for ctr, sc, holder, seq, a, k, kind, src_r, inst in self._cache_ring[s]:
                if kind == _KIND_MAIL:
                    img = mail[inst]
                else:
                    img = (Vstart if kind == _KIND_START else Vagg)[rnd - 1 - src_r, inst]
                put((sc, 2, holder, seq), REPLY_TOPIC, ids[holder], (k, value(img[: sizes[k]])),
                    sc, ctr, wsizes[k], ids[a])
            for send_r, si, di, ver_sent, dl in self._merge_ring[s]:
                k = int(self._inst_k[si])
                t0 = TICKS * send_r + 3
                img = Vagg[rnd - 1 - send_r, si, : sizes[k]]
                put((t0, 3, int(self._inst_owner[si]), si), f"{REPLICA_TOPIC}/{k}", owner_id[si],
                    (k, value(img), ver_sent), t0, t0 + dl, wsizes[k], owner_id[di])
        for _u, entries in sorted(self._mail_merges.items()):
            for key_tick, src_row, ver_sent, di, m, sent_tick in entries:
                k = int(self._inst_k[di])
                put((sent_tick, 3, src_row, di), f"{REPLICA_TOPIC}/{k}", ids[src_row],
                    (k, value(mail[m, : sizes[k]]), ver_sent), sent_tick, key_tick + 1,
                    wsizes[k], owner_id[di])
        for _u in sorted(self._pending_drop_msgs):
            for msg in self._pending_drop_msgs[_u]:
                out.append(((msg.sent_round, 4, 0, 0), msg))
        out.sort(key=lambda e: e[0])
        for _key, msg in out:
            if msg.deliver_round < TICKS * rnd:
                # already due: the scalar tick would have delivered it
                ps._inbox[msg.recipient].append(msg)
                ps.bytes_recv[msg.recipient] += msg.nbytes
            else:
                ps._inflight.append(msg)
        for ring in (self._serve_ring, self._arr_ring, self._cache_ring, self._merge_ring):
            for slot in ring:
                slot.clear()
        self._mail_merges, self._pending_drop_msgs = {}, {}
        self._on_device = False

    def _scalar_round(self, rnd: int) -> dict:
        """One round on the embedded scalar oracle: the membership-event
        rounds, and the rare rounds the dense planes cannot host (no agent
        online, a deferred harvest); the next batched round re-snapshots."""
        if self._on_device:
            with self._phase("device_to_scalar"):
                self._device_to_scalar(rnd)
        with self._phase("oracle_round"):
            met = self._seed.run_round(rnd)
        # keep the mirrored counters live, also for a run that ends here
        ps = self.net.pubsub
        self.messages_sent = ps.messages_sent
        self.messages_dropped = ps.messages_dropped
        self._bytes_total = ps.total_bytes()
        self._n_act = met["active"]
        self.history.append(met)
        return met

    def agent_ids(self) -> List[int]:
        """Live agent ids in the oracle's order: the rows of
        `agent_weights()`. Read from the oracle while the state lives
        there (between an event round and the next span)."""
        if self._lossy and not self._on_device:
            return [a for a, ag in self._seed.agents.items() if ag.live]
        return list(self._ids)

    def _owner_fill(self, rows: np.ndarray) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        pos_of = {int(a): p for p, a in enumerate(rows)}
        fill = []
        for lo, hi in self._inst_rows:
            pairs = [(pos_of[int(self._inst_owner[i])], i) for i in range(lo, hi)
                     if int(self._inst_owner[i]) in pos_of]
            pos = torch.as_tensor([p for p, _ in pairs], dtype=torch.int64, device=self.device)
            inst = torch.as_tensor([i for _, i in pairs], dtype=torch.int64, device=self.device)
            fill.append((pos, inst))
        return fill

    def _assemble(self, V, C, fill, rows=None) -> torch.Tensor:
        """Flat weights of ``rows`` agents (all when None) from the value
        and cache planes."""
        Cr = C if rows is None else C[rows]
        W = torch.cat([Cr[:, k, : int(s)] for k, s in enumerate(self._sizes)], dim=1)
        for k, (pos, inst) in enumerate(fill):
            if len(pos):
                o, sz = int(self._offsets[k]), int(self._sizes[k])
                W[pos, o : o + sz] = V[inst, :sz]
        return W

    def _write_cache(self, C, mask, src, table_parts) -> None:
        """Cache-plane writes of one drain point, in place: slot (a, k)
        takes row ``src[a, k]`` of the concatenated value table where
        ``mask[a, k]``, and keeps its value elsewhere. The span's mail
        plane, when it has one, is the table's last block."""
        if self._mail is not None:
            table_parts = (*table_parts, self._mail)
        T = torch.cat([t.reshape(-1, self.S) for t in table_parts], dim=0)
        torch.where(mask[:, :, None], T[src], C, out=C)

    def _pre(self, st, x):
        """Roll the start-of-round value ring, apply the cache writes the
        scalar engine drains before LoadModel, assemble the online agents'
        flat weights. The value rings store WIRE values — every consumer (fetch
        and UpdateModel-reply cache writes, replica merges) saw the payload
        after one trip over the wire — so under int8 the authoritative V
        stays raw while the ring entry is its quantize->dequantize image."""
        V = st["V"]
        V0 = qdq_rows(V) if self._int8 else V
        Vstart_new = torch.cat([V0[None], st["Vstart_hist"][:-1]], dim=0)
        self._write_cache(st["C"], x["c0_mask"], x["c0_src"], (Vstart_new, st["Vagg_hist"]))
        return Vstart_new, self._assemble(V, st["C"], self._fill_act, self._act_rows)

    def _aggregate_lossy(self, st, D, x) -> torch.Tensor:
        """Aggregate every instance from this round's and the in-flight
        delta windows, in the control plane's delivery order (kidx), through
        one kernel launch; roll the delta ring. ``D`` holds the online rows'
        deltas."""
        A, K, S, Lu, HD = self.A, self.K, self.S, self._Lu, self._HD
        if self._act_rows is not None:
            # offline rows neither send nor contribute: their deltas stay zero
            D = D.new_zeros((A, self.N)).index_copy_(0, self._act_rows, D)
        if not self._int8:
            D_all = torch.cat([D[None], st["ring"]], dim=0)
            st["ring"].copy_(D_all[:Lu])
            G = self._gather_deltas(D_all.reshape(HD * A, self.N), x["kidx"])
            return aggregate_batched(st["V"], G, x["kmask"], x["eps"])
        # int8: every (agent, partition) slice is quantized with its error-
        # feedback residual, updated at send time (loss-independent, like the
        # scalar encode); owner slices never transit, so their residuals stay
        Dplane = torch.zeros((A, K, S), dtype=torch.float32, device=self.device)
        for k, s in enumerate(self._sizes):
            o = int(self._offsets[k])
            Dplane[:, k, :s] = D[:, o : o + s]
        E = st["E"]
        qn, scn, E_new = quantize_rows(Dplane, E)
        E_new[self._own_a, self._own_k] = E[self._own_a, self._own_k]
        if self._off3 is not None:
            # offline agents send nothing: their residuals freeze, as the
            # scalar dict entries do
            E_new = torch.where(self._off3, E, E_new)
        E.copy_(E_new)
        # gather the contributor CODES + SCALES per instance (the owner is not
        # in kidx: its raw delta enters through the kernel's own input)
        Q_all = torch.cat([qn[None], st["ring_q"]], dim=0)
        S_all = torch.cat([scn[None], st["ring_s"]], dim=0)
        st["ring_q"].copy_(Q_all[:Lu])
        st["ring_s"].copy_(S_all[:Lu])
        G_q = Q_all.reshape(HD * A, K, S)[x["kidx"], self._own_k_col]
        G_s = S_all.reshape(HD * A, K, S // BLOCK)[x["kidx"], self._own_k_col]
        d_own = Dplane[self._own_a, self._own_k]
        return aggregate_batched_q(st["V"], d_own, G_q, G_s, x["kmask"], self._ones_inst, x["eps"])

    def _core(self, st, D, Vstart_new, x, do_eval):
        """Aggregation, version-filtered replica consensus, reply-driven
        cache writes, history rings, evaluation. Returns the accuracies
        (None when ``do_eval`` is False)."""
        V_agg = self._aggregate_lossy(st, D, x)
        # everything a post-aggregate value feeds (UpdateModel-reply cache
        # writes, replica publishes) crossed the wire: ring and table the wire
        # image, keep the authoritative V_agg raw. (The reference pins ONE
        # materialization of V_agg with an optimization barrier before this
        # read; eager PyTorch materializes it once by construction.)
        V_aggw = qdq_rows(V_agg) if self._int8 else V_agg
        # replica consensus: mean of self + version-kept arrived values (late
        # values read the post-aggregate ring at their send age), added in
        # the control plane's landing-tick order so the association matches
        # the scalar np.mean over [self] + arrivals. Every column runs: a
        # masked one keeps acc bit for bit
        hist = st["Vagg_hist"]
        Vm_flat = torch.cat([V_aggw[None], hist[: self._HD - 1]], dim=0).reshape(-1, self.S)
        if self._mail is not None:
            Vm_flat = torch.cat([Vm_flat, self._mail], dim=0)
        acc = V_agg
        for j in range(self._mw):
            acc = torch.where(x["mmask"][:, j, None], acc + Vm_flat[x["msrc"][:, j]], acc)
        # phase-2 cache writes (may read this round's post-aggregate table)
        self._write_cache(st["C"], x["c2_mask"], x["c2_src"], (Vstart_new, hist, V_aggw))
        hist.copy_(torch.cat([V_aggw[None], hist[:-1]], dim=0))
        st["Vstart_hist"].copy_(Vstart_new)
        st["V"].copy_(acc / (1.0 + x["cnt"])[:, None])
        if not do_eval:
            return None
        # evaluate the sub-sampled agents on end-of-round state
        W_eval = self._assemble(st["V"], st["C"], self._fill_eval, self._eval_rows)
        return mlp_mnist.evaluate(unflatten_params(W_eval, self.layout), self._x_te, self._y_te)

    def _push_cache_event(self, deliver_ctr, send_ctr, a, k, kind, src_round, inst):
        """Schedule a cache write for the round whose drain sees the message.
        The sort key (deliver_ctr, send_ctr, serving holder ROW, seq)
        reproduces the scalar inbox order — messages delivered at the same
        tick sit in send order, and within one send phase the scalar engine
        loops holders in its agents order, the row order — so when several
        replies race for one (agent, partition) cache slot the same one wins
        in both engines. (Replies from the SAME holder in the same phase
        carry identical values, so their relative order is immaterial.)"""
        holder = int(self._inst_owner[inst])
        self._cache_ring[(deliver_ctr // TICKS_PER_ROUND) % self._HD].append(
            (deliver_ctr, send_ctr, holder, self._seq, a, k, kind, src_round, inst)
        )
        self._seq += 1

    def _control_round(self, rnd: int, wf: _FateWindow):
        """One round of the host-side control plane: request fates sliced
        from the window's pre-drawn ``wf``, reply fate draws, queue-ring
        drains, the fetch warm-up state machine, traffic counters. Pure
        integer/boolean numpy over the fixed-shape event space — no device
        data — so a window runs it W times up front. Routing and every fate
        are keyed by agent IDS (the scalar rules), every dense index runs
        over membership ROWS. Returns the round's fixed-shape control arrays,
        (msgs, drops, nbytes), which are exactly the scalar pubsub's counters
        for the round by construction, and with telemetry on the round's
        contributor counts and post-recursion float64 eps (copies: a window
        runs W control rounds before its replay, and ``_eps64`` moves), else
        None. With telemetry on, each channel's traffic, drops and delivered
        delays are tapped into the recorder, keyed by round."""
        t = self._t
        TICKS = TICKS_PER_ROUND
        qd = HD = self._HD
        f = self._fates
        rec = self.recorder
        A, K, K_inst = self.A, self.K, self.K_inst
        owner, rho, act = self._owner_col, self._rho, self._act
        ids, owner_id = self._ids_arr, self._inst_owner_id
        msgs = drops = nbytes = 0
        k_row = np.arange(K)[None, :]
        # routing: non-owner a targets replica slot (rnd + id_a) % rho_k
        slot = (rnd + self._ids_col) % np.maximum(rho, 1)[None, :]
        tgt_inst = self._slot_inst[np.broadcast_to(k_row, (A, K)), slot]
        # target liveness per (a, k): a delivered-fate message to an offline
        # holder is dropped at the send tick (pubsub send semantics)
        has_tgt = np.broadcast_to(rho[None, :] > 0, (A, K))
        tgt_act = np.zeros((A, K), bool)
        tgt_act[has_tgt] = act[self._inst_owner[tgt_inst[has_tgt]]]

        def lat_rounds(d):
            return -(-d // TICKS)

        # ---- messages harvested at the span's start whose recipient is
        # offline: the scalar tick drops them at their delivery tick
        n_pend = len(self._pending_drop_msgs.pop(t, []))
        drops += n_pend
        if rec is not None:
            rec.on_offline_drops(rnd, n_pend)

        # ---- phase 0: fetch requests for partitions never yet cached ------
        need = act[:, None] & ~owner & ~self._has_cache & has_tgt
        n_need = int(need.sum())
        if n_need:
            de, dl = wf.slice("fetch", t)
            msgs += n_need
            nbytes += 16 * n_need
            n_lost, n_off = int((need & ~de).sum()), int((need & de & ~tgt_act).sum())
            drops += n_lost + n_off
            if rec is not None:
                rec.on_channel(rnd, "fetch", n_need, 16 * n_need, n_lost)
                rec.on_offline_drops(rnd, n_off)
                rec.on_delays(rnd, dl[need & de & tgt_act])
            lat = lat_rounds(dl)
            for a, k in np.argwhere(need & de & tgt_act):
                self._serve_ring[(t + int(lat[a, k])) % qd].append(
                    (t, int(a), int(k), int(tgt_inst[a, k]))
                )

        # ---- phase 1: holders serve the fetches that arrived --------------
        # (one batched draw: a fate is a pure hash of its coordinates, so it
        # equals the scalar pubsub's one-message draws)
        serves, self._serve_ring[t % qd] = self._serve_ring[t % qd], []
        if serves:
            sv = np.asarray(serves, np.int64)  # (send round, agent row, partition, instance)
            de1, d1 = f.draw(CH_FETCH_REPLY, t, ids[sv[:, 1]], sv[:, 2], owner_id[sv[:, 3]])
            msgs += len(serves)
            sv_bytes = int(np.sum(self._wsizes[sv[:, 2]]))
            nbytes += sv_bytes
            drops += int((~de1).sum())
            if rec is not None:
                rec.on_channel(rnd, "fetch_reply", len(serves), sv_bytes, int((~de1).sum()))
                rec.on_delays(rnd, d1[de1])
            for j in np.nonzero(de1)[0]:
                self._push_cache_event(
                    TICKS * t + 1 + int(d1[j]), TICKS * t + 1,
                    int(sv[j, 1]), int(sv[j, 2]), _KIND_START, t, int(sv[j, 3]),
                )

        # ---- phase 2: UpdateModel sends -----------------------------------
        de_u, dl_u = wf.slice("update", t)
        send_u = self._upd_send_mask
        msgs += self._upd_msgs
        nbytes += self._upd_bytes
        n_lost, n_off = int((send_u & ~de_u).sum()), int((send_u & de_u & ~tgt_act).sum())
        drops += n_lost + n_off
        lat_u = lat_rounds(dl_u)
        # ring appends must mirror the scalar inbox, which fills in delivery-
        # TICK order: a message delayed d ticks lands at tick TICKS*t+2+d, so
        # same-send-round arrivals drain delay-ascending first, then publish
        # (a, k) order. np.unique gives the delays sorted ascending.
        live_u = send_u & de_u & tgt_act
        if rec is not None:
            rec.on_channel(rnd, "update", self._upd_msgs, self._upd_bytes, n_lost)
            rec.on_offline_drops(rnd, n_off)
            rec.on_delays(rnd, dl_u[live_u])
        for d in np.unique(dl_u[live_u]):
            for a, k in np.argwhere(live_u & (dl_u == d)):
                self._arr_ring[(t + int(lat_u[a, k])) % qd].append(
                    (t, int(a), int(k), int(tgt_inst[a, k]))
                )

        # ---- arrivals => contributor tables + UpdateModel replies ---------
        arrivals, self._arr_ring[t % qd] = self._arr_ring[t % qd], []
        # per-instance contributor columns of the (age, agent) delta table,
        # in scalar DELIVERY order: the ring drains in append order = (send
        # round ascending, then tick-delay ascending, then (a, k) send
        # order), exactly the scalar pubsub's FIFO inbox — the order the
        # sequential-sum kernels must reduce in
        contrib_cols: List[List[int]] = [[] for _ in range(K_inst)]
        for send_r, a, _k, inst in arrivals:
            contrib_cols[inst].append((t - send_r) * A + a)
        # an online owner pushes its own delta; an offline one neither trains
        # nor aggregates, so its r stays 0 and its eps and version freeze
        own_on = act[self._inst_owner]
        r_vec = own_on + np.asarray([len(c) for c in contrib_cols], np.float64)
        # eps recursion in float64 on the host — bit-identical to the scalar
        # engine's python-float `eps = alpha*eps + (1-alpha)/r`; the device
        # consumes only the f32 image of the post-recursion value
        alpha = self.cfg.alpha
        self._eps64 = np.where(
            r_vec > 0, alpha * self._eps64 + (1.0 - alpha) / np.maximum(r_vec, 1.0), self._eps64
        )
        if arrivals:
            arr = np.asarray([(a, k, i) for (_, a, k, i) in arrivals], np.int64)
            de_r, d_r = f.draw(CH_UPDATE_REPLY, t, ids[arr[:, 0]], arr[:, 1], owner_id[arr[:, 2]])
            msgs += len(arrivals)
            rep_bytes = int(np.sum(self._wsizes[arr[:, 1]]))
            nbytes += rep_bytes
            drops += int((~de_r).sum())
            if rec is not None:
                rec.on_channel(rnd, "update_reply", len(arrivals), rep_bytes, int((~de_r).sum()))
                rec.on_delays(rnd, d_r[de_r])
            for j in np.nonzero(de_r)[0]:
                self._push_cache_event(
                    TICKS * t + 3 + int(d_r[j]), TICKS * t + 3,
                    int(arr[j, 0]), int(arr[j, 1]), _KIND_AGG, t, int(arr[j, 2]),
                )
        # a version bumps where anything aggregated
        ver_after = self._ver + (r_vec > 0)

        # ---- replica publishes --------------------------------------------
        if len(self._rep_src):
            msgs += self._pub_msgs
            nbytes += self._pub_bytes
            de_p, dl_p = wf.slice("replica", t)
            n_lost, n_off = int((~de_p).sum()), int((de_p & ~self._rep_dst_act).sum())
            drops += n_lost + n_off
            if rec is not None:
                rec.on_channel(rnd, "replica", self._pub_msgs, self._pub_bytes, n_lost)
                rec.on_offline_drops(rnd, n_off)
                rec.on_delays(rnd, dl_p[de_p & self._rep_dst_act])
            lat_p = lat_rounds(dl_p)
            for j in np.nonzero(de_p & self._rep_dst_act)[0]:
                si, di = int(self._rep_src[j]), int(self._rep_dst[j])
                self._merge_ring[(t + int(lat_p[j])) % qd].append(
                    (t, si, di, int(ver_after[si]), int(dl_p[j]))
                )

        # ---- merge set: version-filtered replica values due this round ----
        # ordered columns into the flattened (HD*K_inst) value-history table
        # (then the mail plane), sorted by (landing tick - 1, send tick,
        # source row) = the scalar inbox's FIFO drain order, so the device's
        # sequential merge associates exactly like the scalar oracle's
        # np.mean over [self] + arrivals. A value published at tick
        # TICKS*send_r + 3 with delay dl lands at +3 + dl; a harvested (mail)
        # entry carries its own key.
        msrc = np.zeros((K_inst, self._mw), np.int64)
        mmsk = np.zeros((K_inst, self._mw), bool)
        cnt = np.zeros(K_inst, np.float32)
        merges, self._merge_ring[t % qd] = self._merge_ring[t % qd], []
        entries = [
            (send_r * TICKS + 2 + dl, send_r * TICKS + 3, int(self._inst_owner[si]),
             di, ver_sent, (t - send_r) * K_inst + si)
            for send_r, si, di, ver_sent, dl in merges
        ] + [
            (kt, st_, sr, di, vs, HD * K_inst + m)
            for kt, sr, vs, di, m, st_ in self._mail_merges.pop(t, [])
        ]
        entries.sort(key=lambda e: e[:3])
        for _kt, _st, _sr, di, ver_sent, col_src in entries:
            if ver_sent >= ver_after[di]:
                col = int(cnt[di])
                msrc[di, col] = col_src
                mmsk[di, col] = True
                cnt[di] += 1.0
        self._ver = ver_after

        # ---- cache writes (phase-0 / phase-2 drains), fixed shape ---------
        # source rows index the concatenated value tables of _pre
        # ([Vstart ring; Vagg ring; mail]) and _core ([Vstart ring; Vagg
        # ring; this round's V_agg; mail]); later deliveries to one slot
        # overwrite earlier ones
        c0_mask = np.zeros((A, K), bool)
        c0_src = np.zeros((A, K), np.int64)
        c2_mask = np.zeros((A, K), bool)
        c2_src = np.zeros((A, K), np.int64)
        cache_events, self._cache_ring[t % qd] = self._cache_ring[t % qd], []
        for ctr, _sc, _holder, _seq, a, k, kind, src_r, inst in sorted(cache_events):
            is_c0 = ctr % TICKS <= 1
            if kind == _KIND_MAIL:
                # `inst` is a mail-plane row, after the tables' value blocks
                idx = (2 * HD + (0 if is_c0 else 1)) * K_inst + inst
            elif kind == _KIND_START:
                idx = (t - src_r) * K_inst + inst
            elif src_r < t:
                idx = HD * K_inst + (t - src_r - 1) * K_inst + inst
            else:
                idx = 2 * HD * K_inst + inst
            if is_c0:
                c0_mask[a, k], c0_src[a, k] = True, idx
            else:
                c2_mask[a, k], c2_src[a, k] = True, idx
            self._has_cache[a, k] = True  # suppresses fetches from round t+1

        # ---- contributor tables, slot order = reduction order -------------
        # the scalar pending order: own delta first (the local push precedes
        # the inbox drain), then arrivals in delivery order. The quantized
        # kernel takes the owner's raw delta through a dedicated input summed
        # first (an offline owner's delta row is zero), so its table holds
        # only the remote rows
        kidx = np.zeros((K_inst, self.R_cap), np.int64)
        kmask = np.zeros((K_inst, self.R_cap), np.float32)
        for i in range(K_inst):
            own = [] if self._int8 or not own_on[i] else [int(self._inst_owner[i])]
            rows = own + contrib_cols[i]
            kidx[i, : len(rows)] = rows
            kmask[i, : len(rows)] = 1.0

        self._t = t + 1
        ctl = dict(
            c0_mask=c0_mask, c0_src=c0_src, c2_mask=c2_mask, c2_src=c2_src,
            msrc=msrc, mmask=mmsk, cnt=cnt, eps=self._eps64.astype(np.float32),
            kidx=kidx, kmask=kmask,
        )
        snap = None if rec is None else (r_vec.astype(np.int64), self._eps64.copy())
        return ctl, (msgs, drops, nbytes), snap

    # -- introspection (tests / benchmarks) ---------------------------------
    def agent_weights(self) -> np.ndarray:
        """The (A, N) matrix of per-agent assembled models over the live
        agents (rows in `agent_ids()` order), equal to what each scalar
        agent's `load_model()` would return (reconstructed from the value
        tables and the last round's routing). Read from the oracle while the
        state lives there."""
        if self._lossy and not self._on_device:
            return np.stack([self._seed.agents[a].load_model() for a in self.agent_ids()])
        st = self._state
        if self._lossy:
            fill = self._owner_fill(np.arange(self.A))
            return self._assemble(st["V"], st["C"], fill).cpu().numpy()
        V_all = torch.cat([st["V_pre"], st["V_merged"]], dim=0).cpu().numpy()
        t_inst = self._t_inst[self._last_phase]
        W = np.zeros((self.A, self.N), np.float32)
        for k in range(self.K):
            off, s = self._offsets[k], self._sizes[k]
            W[:, off : off + s] = V_all[t_inst[:, k], :s]
        return W
