"""Vectorized IPLS round engine on PyTorch: whole-round batching across agents.

Counterpart of ``repro.fl.vectorized`` for PERFECT network conditions, the
f32 wire and a fixed membership. The scalar engine (`fl/rounds.py`) trains
one agent at a time and reduces one partition at a time in numpy; this
engine runs the same per-round dataflow as a few batched device phases:

  1. ``build_W``: every agent's flat weights, assembled as one (A, N) matrix
     from the per-instance value tables;
  2. ``sgd_all``: local SGD for all A agents at once
     (`mlp_mnist.sgd_steps_flat_batched`, one batched product per layer);
  3. ``agg_merge``: every (partition, replica-slot) instance's contributor
     deltas gathered into one (K_inst, R, S) plane and aggregated in ONE
     launch of the hand-written CUDA kernel (`kernels/ipls_aggregate`),
     then replica consensus;
  4. ``eval_rows``: evaluation of the (sub-sampled) agents in one batch.

Only the small per-instance value tables (V_pre, V_merged, eps) persist
between rounds; the (A, N) matrices live and die inside the round.

Exactness: under PERFECT conditions with a fixed membership the scalar
engine is deterministic — every agent sends each non-owned partition's delta
to holder `H(k)[(round + agent) % rho_k]`, holders aggregate
`w -= eps * sum(deltas)` with the eps recursion, replicas mean-merge AFTER
replies are served (so caches hold pre-merge per-replica values), and agents
assemble owned->merged / cached->pre-merge views. This engine replicates
exactly that, including the per-agent batch RNG streams, so the two engines
agree to float tolerance round by round (tests/test_torch_engine.py).
Traffic is computed in closed form and matches the scalar pubsub counters
exactly.

Lossy networks, the int8 wire, churn and multi-round windows are later
slices of the port; such configurations raise NotImplementedError.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.partition import unflatten_params
from repro_torch.core.wire import wire_size
from repro_torch.device import resolve_device
from repro_torch.fl.rounds import IPLSSimulation, eval_subset
from repro_torch.kernels.ipls_aggregate.ops import aggregate_batched
from repro_torch.models import mlp_mnist
from repro_torch.telemetry import NULL_TIMER


def _check_in_slice(cfg) -> None:
    later = []
    if cfg.conditions.loss_prob > 0 or cfg.conditions.delay_prob > 0:
        later.append("lossy or delayed network conditions (the LOSSY slice)")
    if cfg.wire_dtype != "f32":
        later.append(f"wire_dtype={cfg.wire_dtype!r} (the int8 slice)")
    if cfg.scan_rounds:
        later.append("scan_rounds > 0 (the multi-round window slice)")
    if cfg.churn:
        later.append("churn (the churn re-snapshot slice)")
    if later:
        raise NotImplementedError(
            "the port's vectorized engine runs PERFECT conditions on the f32 wire "
            "with a fixed membership; not yet ported: " + "; ".join(later)
        )


class VectorizedIPLSSimulation:
    """Batched engine with the same interface as `IPLSSimulation`.

    Construction delegates to the scalar engine so the bootstrap/join
    protocol (partition transfers, donor caches, membership traffic) is
    byte-for-byte identical; the resulting state is then snapshotted into
    dense tensors on ``device`` and all rounds run batched.
    """

    def __init__(self, cfg, shards, x_test, y_test, device="cuda"):
        _check_in_slice(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        # round programs run on the device: one per round (the reference
        # counts its jitted calls the same way)
        self.device_dispatches = 0
        # phase timer: assign a telemetry.PhaseTimer to time the round phases
        self.timer = NULL_TIMER
        # exact init state + init-phase traffic via the scalar constructor
        seed_sim = IPLSSimulation(cfg, shards, x_test, y_test, device=self.device)
        self.net = seed_sim.net
        self.spec = seed_sim.spec
        self.table = seed_sim.table
        self.layout = seed_sim.layout
        self.history: List[dict] = []

        A = cfg.num_agents
        K = self.spec.num_partitions
        sizes = np.asarray(self.spec.sizes, np.int64)
        offsets = np.asarray(self.spec.offsets(), np.int64)
        self.A, self.K, self.N = A, K, self.spec.total

        # ---- instance plane: one row per (partition, replica-slot) --------
        holders: List[List[int]] = [self.table.holders_of(k) for k in range(K)]
        inst_k: List[int] = []
        inst_owner: List[int] = []
        inst_id: Dict[Tuple[int, int], int] = {}
        for k in range(K):
            for j, h in enumerate(holders[k]):
                inst_id[(k, j)] = len(inst_k)
                inst_k.append(k)
                inst_owner.append(h)
        self.K_inst = len(inst_k)
        self._inst_k = np.asarray(inst_k, np.int64)
        self._inst_owner = np.asarray(inst_owner, np.int64)
        rho = np.asarray([len(h) for h in holders], np.int64)

        # padded instance size: tail zeros flow through the kernel untouched
        # (0 - eps*0), so one shared width serves all partitions
        self.S = int(sizes.max())
        self._sizes = sizes
        self._offsets = offsets
        # per-partition wire payload bytes: every closed-form byte count
        # below derives from these
        self._wsizes = np.asarray([wire_size(int(s), cfg.wire_dtype) for s in sizes], np.int64)

        # ---- snapshot values / eps from the scalar init -------------------
        V_pre = np.zeros((self.K_inst, self.S), np.float32)
        eps = np.ones((self.K_inst,), np.float32)
        for k in range(K):
            for j, h in enumerate(holders[k]):
                st = seed_sim.agents[h].owned[k]
                V_pre[inst_id[(k, j)], : sizes[k]] = st.value
                eps[inst_id[(k, j)]] = st.eps
        owner_col = np.zeros((A, K), bool)
        for k in range(K):
            for h in holders[k]:
                owner_col[h, k] = True
        self._bytes_total = self.net.pubsub.total_bytes()
        # message counters mirroring the scalar pubsub (init-phase membership
        # traffic included via the snapshot)
        self.messages_sent = self.net.pubsub.messages_sent
        self.messages_dropped = self.net.pubsub.messages_dropped

        # ---- trainers: the scalar constructor's LocalTrainer objects own
        # the per-agent RNG streams; drawing batches through their
        # draw_batch() keeps both engines' SGD inputs identical ----
        self._trainers = [seed_sim.trainers[a] for a in range(A)]
        bs = [min(cfg.batch_size, len(shards[a][0])) for a in range(A)]
        # contiguous buckets of equal batch size (array_split shard sizes
        # differ by at most one, so there are at most two)
        self._buckets: List[Tuple[int, int]] = []
        start = 0
        for a in range(1, A + 1):
            if a == A or bs[a] != bs[start]:
                self._buckets.append((start, a))
                start = a

        self._eval_idx = np.asarray(eval_subset(list(range(A)), cfg.eval_agents), np.int64)

        # round-0 warm-up traffic (agents fetch partitions absent from both
        # their owned set and the donor caches left behind by joins)
        fetch_bytes = fetch_msgs = 0
        for a in range(A):
            ag = seed_sim.agents[a]
            for k in range(K):
                if k not in ag.owned and k not in ag.cache:
                    fetch_bytes += 16 + int(self._wsizes[k])
                    fetch_msgs += 2  # the fetch and its reply
        self._round0_fetch_bytes = fetch_bytes
        self._round0_fetch_msgs = fetch_msgs

        # steady-state per-round traffic: every agent updates every non-owned
        # partition (one wire payload up + one reply) and each replica of a
        # rho_k>1 partition publishes once for consensus
        upd = int(np.sum((A - rho) * self._wsizes))
        replica = int(np.sum(np.where(rho > 1, rho * self._wsizes, 0)))
        self._round_bytes = 2 * upd + replica
        self._round_msgs = 2 * int(np.sum(A - rho)) + int(np.sum(np.where(rho > 1, rho, 0)))

        # ---- per-phase routing tables (period = lcm of replication) -------
        # non-owner a targets H(k)[(round + a) % rho_k]; the pattern repeats
        # with period lcm(rho_k), so all gather index tensors are
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

        # ---- device state and constants -----------------------------------
        dev = self.device
        self._V_pre = torch.as_tensor(V_pre, device=dev)
        self._V_merged = self._V_pre.clone()  # all replicas equal at init
        self._eps = torch.as_tensor(eps, device=dev)
        self._last_phase = self._period - 1  # any phase: all replicas equal at init
        self._t_inst = t_insts  # host copies, for agent_weights()
        self._phase_tables = []
        for p in range(self._period):
            idx = np.zeros((self.K_inst, R_cap), np.int64)
            msk = np.zeros((self.K_inst, R_cap), np.float32)
            for i, row in enumerate(contrib_rows[p]):
                idx[i, : len(row)] = row
                msk[i, : len(row)] = 1.0
            self._phase_tables.append(
                tuple(
                    torch.as_tensor(a, device=dev)
                    for a in (idx, msk, t_insts[p], t_insts[p][self._eval_idx])
                )
            )
        # instance rows are k-major: partition k's instances are one row range
        self._inst_rows = [
            (int(np.searchsorted(self._inst_k, k)), int(np.searchsorted(self._inst_k, k, "right")))
            for k in range(K)
        ]
        self._morder = torch.as_tensor(morder, device=dev)
        self._mmask = torch.as_tensor(mmask, device=dev)
        self._rho_inst = torch.as_tensor(rho[self._inst_k].astype(np.float32), device=dev)
        self._x_te, self._y_te = seed_sim._x_te, seed_sim._y_te

    # -- batched phases ------------------------------------------------------
    @contextmanager
    def _phase(self, name: str):
        """A timed phase; with a PhaseTimer attached, device work is
        synchronized at its end so it cannot leak into the next phase."""
        with self.timer.phase(name):
            yield
            if self.timer.sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

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
        cfg = self.cfg
        parts = [
            mlp_mnist.sgd_steps_flat_batched(
                W[lo:hi], Xs[b], Ys[b], cfg.lr, cfg.local_iters, self.layout
            )
            for b, (lo, hi) in enumerate(self._buckets)
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

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
        D = W - W2
        G = torch.empty((self.K_inst, self.R_cap, self.S), dtype=D.dtype, device=D.device)
        for k, (lo, hi) in enumerate(self._inst_rows):
            o, sz = int(self._offsets[k]), int(self._sizes[k])
            G[lo:hi, :, :sz] = D[:, o : o + sz][contrib_idx[lo:hi]]
            G[lo:hi, :, sz:] = 0.0
        V_pre = aggregate_batched(V_merged, G, contrib_mask, eps_new)
        # replica consensus: each instance averages [self] + the other
        # replicas in arrival (holder agent ascending) order, then a true
        # divide by rho — the scalar engine's np.mean associates this way
        acc = V_pre
        for j in range(1, self._morder.shape[1]):
            acc = torch.where(self._mmask[:, j, None], acc + V_pre[self._morder[:, j]], acc)
        return V_pre, acc / self._rho_inst[:, None], eps_new

    def eval_rows(self, V_pre, V_merged, t_eval) -> torch.Tensor:
        """Accuracy of the sub-sampled agents: their assembled rows only, so
        the full (A, N) matrix is never evaluated."""
        W_eval = self.build_W(V_pre, V_merged, t_eval)
        return mlp_mnist.evaluate(unflatten_params(W_eval, self.layout), self._x_te, self._y_te)

    # -- one round ----------------------------------------------------------
    def _draw_batches(self):
        xs, ys = [], []
        for tr in self._trainers:
            xb, yb = tr.draw_batch()
            xs.append(xb)
            ys.append(yb)
        return xs, ys

    def run_round(self, rnd: int) -> dict:
        dev = self.device
        with self._phase("batches"):
            xs, ys = self._draw_batches()
            Xs = [torch.as_tensor(np.stack(xs[lo:hi]), device=dev) for lo, hi in self._buckets]
            Ys = [torch.as_tensor(np.stack(ys[lo:hi]), device=dev) for lo, hi in self._buckets]
        p = rnd % self._period
        idx, mask, _, t_eval = self._phase_tables[p]
        t_prev = self._phase_tables[self._last_phase][2]
        with self._phase("build_w"):
            W = self.build_W(self._V_pre, self._V_merged, t_prev)
        with self._phase("sgd"):
            W2 = self.sgd_all(W, Xs, Ys)
        with self._phase("aggregate"):
            self._V_pre, self._V_merged, self._eps = self.agg_merge(
                self._V_merged, self._eps, W, W2, idx, mask
            )
        del W, W2
        with self._phase("eval"):
            accs = self.eval_rows(self._V_pre, self._V_merged, t_eval).cpu().numpy()
        self.device_dispatches += 1
        self._last_phase = p
        self._perfect_traffic(rnd)
        metrics = self._metrics_entry(rnd, accs)
        self.history.append(metrics)
        return metrics

    def _perfect_traffic(self, rnd: int) -> None:
        self._bytes_total += self._round_bytes + (
            self._round0_fetch_bytes if rnd == 0 else 0
        )
        # keep the pubsub-mirroring counters live (nothing drops under
        # PERFECT conditions)
        self.messages_sent += self._round_msgs + (
            self._round0_fetch_msgs if rnd == 0 else 0
        )

    def _metrics_entry(self, rnd: int, accs: np.ndarray) -> dict:
        return {
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std()),
            "acc_max": float(accs.max()),
            "round": rnd,
            "active": self.A,
            "bytes_total": self._bytes_total,
        }

    def run(self) -> List[dict]:
        for rnd in range(self.cfg.rounds):
            self.run_round(rnd)
        return self.history

    # -- introspection (tests / benchmarks) ---------------------------------
    def agent_weights(self) -> np.ndarray:
        """The (A, N) matrix of per-agent assembled models, equal to what
        each scalar agent's `load_model()` would return (reconstructed from
        the value tables and the last round's routing)."""
        V_all = torch.cat([self._V_pre, self._V_merged], dim=0).cpu().numpy()
        t_inst = self._t_inst[self._last_phase]
        W = np.zeros((self.A, self.N), np.float32)
        for k in range(self.K):
            off, s = self._offsets[k], self._sizes[k]
            W[:, off : off + s] = V_all[t_inst[:, k], :s]
        return W
