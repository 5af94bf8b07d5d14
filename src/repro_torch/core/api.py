"""The IPLS middleware API (paper §2.2): Init, UpdateModel, LoadModel, Terminate.

Each ``IPLSAgent`` is the paper's middleware instance running on one device:
it owns a set of partitions (per the PartitionTable control plane), keeps the
authoritative values + eps state for those partitions, caches the latest
values of all other partitions (populated by UpdateModel replies), and talks
to peers through the (simulated) IPFS substrate.

The message protocol per training round:
  1. trainer computes local delta dW = W_local_before - W_local_after;
  2. UpdateModel(dW): slice dW by partition; for each partition pick a
     responsible agent (paper: 'many criteria ... such as locality, load';
     we use round-robin over holders keyed by (round, agent) for determinism)
     and send (partition_id, delta_slice); the holder replies with the updated
     global sub-vector, which lands in the cache;
  3. holders aggregate all deltas received for their partitions with the
     eps-weighted masked sum and, when rho > 1,
     exchange replica values on the partition topic and run replica consensus;
  4. LoadModel(): concatenate cache + owned values into the full W.

Serialization is numpy ``tobytes`` — the byte counts drive the scalability
benchmark (paper §3 'the data sent and received by each agent is constant').

Counterpart of ``repro.core.api``: the same numpy protocol, message for
message, including the single-rounding f64 update in ``aggregate``, and
the state snapshot hooks the batched engine's churn re-snapshot uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.partition import PartitionSpec, PartitionTable
from repro_torch.core.wire import F32Wire
from repro_torch.p2p.ipfs_sim import SimIPFS

UPDATE_TOPIC = "ipls/update"
REPLY_TOPIC = "ipls/reply"
REPLICA_TOPIC = "ipls/replica"
MEMBER_TOPIC = "ipls/membership"
FETCH_TOPIC = "ipls/fetch"


@dataclasses.dataclass
class PartitionState:
    value: np.ndarray  # authoritative value of the owned partition
    eps: float = 1.0  # staleness weight (paper's epsilon)
    version: int = 0
    # dense message plane: contributor deltas land in a preallocated
    # (capacity, size) row buffer instead of a python list of arrays — the
    # buffer feeds the (batched) aggregation kernels directly and amortizes
    # all per-message allocations across rounds.
    pending: Optional[np.ndarray] = None
    pending_n: int = 0

    def push_delta(self, sl: np.ndarray) -> None:
        if self.pending is None:
            self.pending = np.empty((4, self.value.size), np.float32)
        elif self.pending_n == self.pending.shape[0]:
            grown = np.empty((2 * self.pending.shape[0], self.value.size), np.float32)
            grown[: self.pending_n] = self.pending
            self.pending = grown
        self.pending[self.pending_n] = sl
        self.pending_n += 1

    def drain_pending(self) -> Optional[np.ndarray]:
        """View of the r delta rows received this round (None when empty);
        resets the row count but keeps the allocation."""
        if self.pending_n == 0:
            return None
        rows = self.pending[: self.pending_n]
        self.pending_n = 0
        return rows


class IPLSAgent:
    """One agent's middleware. Control plane state is shared via ``table``
    (in a real deployment the table is replicated through pub/sub membership
    messages; the simulation shares the object and still sends the membership
    traffic for accounting)."""

    def __init__(
        self,
        agent_id: int,
        substrate: SimIPFS,
        table: PartitionTable,
        spec: PartitionSpec,
        alpha: float = 0.5,
        wire=None,
    ):
        self.id = agent_id
        self.net = substrate
        self.table = table
        self.spec = spec
        self.alpha = alpha
        self.wire = wire if wire is not None else F32Wire()
        self.owned: Dict[int, PartitionState] = {}
        self.cache: Dict[int, np.ndarray] = {}
        self._requesters: Dict[int, List[int]] = {}
        # error-feedback residual per partition this agent sends deltas FOR
        # (int8 wire only; residuals update at encode time, i.e. regardless
        # of whether the network later drops the message — deterministic and
        # loss-independent, which the vectorized scan carry mirrors)
        self._delta_err: Dict[int, np.ndarray] = {}
        self.live = True

    # -- Init --------------------------------------------------------------
    def init(self, w0: Optional[np.ndarray] = None) -> None:
        """Join the training process. First agent bootstraps with the full
        model w0; later agents acquire partitions per the join rule and fetch
        initial values from current holders (simulated via the store)."""
        for topic in (UPDATE_TOPIC, REPLY_TOPIC, REPLICA_TOPIC, MEMBER_TOPIC, FETCH_TOPIC):
            self.net.pubsub.subscribe(topic, self.id)
        offsets = self.spec.offsets()
        if not self.table.agents:
            assert w0 is not None, "bootstrap agent must supply initial weights"
            self.table.bootstrap(self.id)
            for k in self.table.partitions_of(self.id):
                sl = w0[offsets[k] : offsets[k] + self.spec.sizes[k]]
                self.owned[k] = PartitionState(value=sl.astype(np.float32).copy())
            for k in self.owned:
                self._subscribe_partition(k)
            # announce (init broadcast in the paper)
            self.net.pubsub.publish(
                MEMBER_TOPIC, self.id, ("init", self.id), nbytes=64
            )
            _AGENTS[self.id] = self
            return
        acquired = self.table.join(self.id)
        # fetch current values for acquired partitions. A partition may have
        # been TRANSFERRED (the donor is no longer in the table but still
        # holds the value) or REPLICATED (a current holder has it).
        for k in acquired:
            still_holding = set(self.table.holders_of(k))
            val, eps, ver, src = None, 1.0, 0, None
            for other_id in sorted(_AGENTS):
                other = _AGENTS[other_id]
                if other.id != self.id and k in other.owned:
                    val = other.owned[k].value.copy()
                    eps = other.owned[k].eps
                    # carry the version too: a replica restarting at 0 would
                    # trail the incumbents forever and merge_replicas would
                    # discard its publishes as stale
                    ver = other.owned[k].version
                    src = other
                    break
            if val is None:
                val = np.zeros(self.spec.sizes[k], np.float32)
            if src is not None and src.id not in still_holding:
                # transfer: the donor relinquishes responsibility (keeps a
                # cached copy for LoadModel, like any non-holder)
                src.cache[k] = src.owned.pop(k).value
                src._unsubscribe_partition(k)
            self.owned[k] = PartitionState(value=val, eps=eps, version=ver)
            self._subscribe_partition(k)
            # account for the partition transfer over the wire (one-time f32
            # bootstrap: join transfers stay uncompressed in every wire mode)
            self.net.pubsub.publish(
                MEMBER_TOPIC, self.id, ("join", self.id, k), 64 + val.nbytes
            )
        _AGENTS[self.id] = self

    # -- UpdateModel ---------------------------------------------------------
    def update_model(self, delta: np.ndarray, round_idx: int) -> None:
        """Send each partition's delta slice to one responsible agent."""
        if not self.live:
            return
        offsets = self.spec.offsets()
        for k in range(self.spec.num_partitions):
            sl = delta[offsets[k] : offsets[k] + self.spec.sizes[k]]
            if k in self.owned:
                # local contribution to my own partition: no network traffic
                self.owned[k].push_delta(sl)
                continue
            holders = self.table.holders_of(k)
            if not holders:
                continue
            # deterministic load-balancing over holders
            target = holders[(round_idx + self.id) % len(holders)]
            err = self._delta_err.get(k)
            if err is None:
                err = np.zeros(sl.shape[0], np.float32)
            payload, nb, new_err = self.wire.encode_delta(sl.astype(np.float32), err)
            self._delta_err[k] = new_err
            self.net.pubsub.send(
                UPDATE_TOPIC,
                self.id,
                target,
                (k, payload),
                nbytes=nb,
            )

    # -- holder side ---------------------------------------------------------
    def collect(self) -> None:
        """Drain incoming delta messages into pending buffers."""
        if not self.live:
            return
        for msg in self.net.pubsub.drain(self.id, UPDATE_TOPIC):
            k, wp = msg.payload
            if k in self.owned:
                self.owned[k].push_delta(self.wire.decode(wp))
                self._requesters.setdefault(k, []).append(msg.sender)

    def serve_replies(self) -> None:
        """After aggregating, reply to every requester with the fresh
        sub-vector (the UpdateModel reply of the paper)."""
        if not self.live:
            return
        for k, requesters in self._requesters.items():
            for requester in requesters:
                self.serve_reply(requester, k)
        self._requesters.clear()

    def aggregate(self) -> None:
        """Paper §2.2: the holder subtracts the received deltas weighted by
        eps, with eps <- alpha*eps + (1-alpha)*(1/r). Since eps's fixed point
        is 1/r, the coherent reading is w_k <- w_k - eps * SUM(deltas): the
        steady-state update is then the MEAN delta, matching centralized
        FedAvg (the mean*eps reading double-normalizes by r and slows
        convergence r-fold). eps is refreshed from
        the current r BEFORE applying, which bounds the first-round overshoot."""
        if not self.live:
            return
        for k, st in self.owned.items():
            deltas = st.drain_pending()
            if deltas is None:
                continue
            r = deltas.shape[0]
            st.eps = self.alpha * st.eps + (1.0 - self.alpha) / r
            agg = deltas.sum(axis=0)
            # Apply w - eps*agg with ONE f32 rounding, as the batched
            # engine's kernel does with one fmaf. The f64 product of two f32
            # values is exact, so the final cast is the single rounding
            # (up to the rare double-rounding tie the kernel's plain
            # version resolves; kernels/ipls_aggregate/ref.py).
            eps32 = np.float64(np.float32(st.eps))
            st.value = (
                st.value.astype(np.float64) - eps32 * agg.astype(np.float64)
            ).astype(np.float32)
            st.version += 1

    def _subscribe_partition(self, k: int) -> None:
        """Paper: 'Every device holding that replication subscribes to its
        topic' — one pub/sub topic per partition."""
        self.net.pubsub.subscribe(f"{REPLICA_TOPIC}/{k}", self.id)

    def _unsubscribe_partition(self, k: int) -> None:
        self.net.pubsub.unsubscribe(f"{REPLICA_TOPIC}/{k}", self.id)

    def sync_replicas(self, round_idx: int) -> None:
        """rho > 1: exchange replica values on the partition topic and average
        (replica consensus). The paper does this through pub/sub topics, one
        per partition."""
        if not self.live:
            return
        for k, st in self.owned.items():
            if self.table.replication(k) <= 1:
                continue
            payload, nb = self.wire.encode_value(st.value)
            self.net.pubsub.publish(
                f"{REPLICA_TOPIC}/{k}", self.id, (k, payload, st.version), nb
            )

    def merge_replicas(self) -> None:
        if not self.live:
            return
        incoming: Dict[int, List[np.ndarray]] = {}
        for msg in self.net.pubsub.drain(self.id, REPLICA_TOPIC):
            k, wp, ver = msg.payload
            val = self.wire.decode(wp)
            # a delayed replica value published in an earlier round carries an
            # older version; mean-merging it next to fresh values would drag
            # the partition backwards — discard anything staler than us
            if k in self.owned and ver >= self.owned[k].version:
                incoming.setdefault(k, []).append(val)
        for k, vals in incoming.items():
            st = self.owned[k]
            st.value = np.mean(np.stack([st.value] + vals), axis=0)

    def serve_reply(self, requester: int, k: int) -> None:
        """Reply to an UpdateModel with the fresh global sub-vector."""
        st = self.owned.get(k)
        if st is None or not self.live:
            return
        payload, nb = self.wire.encode_value(st.value)
        self.net.pubsub.send(REPLY_TOPIC, self.id, requester, (k, payload), nb)

    def receive_replies(self) -> None:
        if not self.live:
            return
        for msg in self.net.pubsub.drain(self.id, REPLY_TOPIC):
            k, wp = msg.payload
            self.cache[k] = self.wire.decode(wp)

    # -- initial parameter collection (paper: 'each agent initially contacts
    # enough agents to collect the global parameters') -----------------------
    def request_missing(self, round_idx: int = 0) -> None:
        if not self.live:
            return
        for k in range(self.spec.num_partitions):
            if k in self.owned or k in self.cache:
                continue
            holders = self.table.holders_of(k)
            if not holders:
                continue
            target = holders[(round_idx + self.id) % len(holders)]
            self.net.pubsub.send(FETCH_TOPIC, self.id, target, (k,), nbytes=16)

    def serve_fetches(self) -> None:
        if not self.live:
            return
        for msg in self.net.pubsub.drain(self.id, FETCH_TOPIC):
            (k,) = msg.payload
            self.serve_reply(msg.sender, k)

    # -- LoadModel -------------------------------------------------------------
    def load_model(self) -> np.ndarray:
        """Assemble the full W from owned partitions + cache. Partitions never
        seen fall back to zeros (cold cache, only possible before round 1)."""
        offsets = self.spec.offsets()
        w = np.zeros(self.spec.total, np.float32)
        for k in range(self.spec.num_partitions):
            if k in self.owned:
                w[offsets[k] : offsets[k] + self.spec.sizes[k]] = self.owned[k].value
            elif k in self.cache:
                w[offsets[k] : offsets[k] + self.spec.sizes[k]] = self.cache[k]
        return w

    # -- Snapshot hooks ----------------------------------------------------------
    # Used by the batched engine's churn re-snapshot (fl/vectorized.py): at a
    # membership-event boundary the dense device planes are written back into
    # the scalar agents (import), the event round replays on the scalar
    # oracle, and the next span reads the updated state back.
    def export_state(self) -> dict:
        """Protocol state as plain dicts of arrays and scalars: owned
        partition values with their (eps, version), the cached global parts,
        and the int8 error-feedback residuals. Values are the live arrays,
        not copies: callers copy them into dense planes at once."""
        return {
            "owned": {k: (st.value, st.eps, st.version) for k, st in self.owned.items()},
            "cache": dict(self.cache),
            "delta_err": dict(self._delta_err),
        }

    def import_state(
        self,
        owned: Dict[int, Tuple[np.ndarray, float, int]],
        cache: Dict[int, np.ndarray],
        delta_err: Optional[Dict[int, np.ndarray]] = None,
    ) -> None:
        """Overwrite protocol state from dense-plane values (copied). Only
        partitions this agent owns now (per the shared table) are accepted;
        their pending delta buffers reset (the caller re-injects in-flight
        messages through the pubsub instead)."""
        for k, (val, eps, ver) in owned.items():
            st = self.owned.get(k)
            if st is None:
                continue
            st.value = np.asarray(val, np.float32).copy()
            st.eps = float(eps)
            st.version = int(ver)
            st.pending_n = 0
        self.cache = {k: np.asarray(v, np.float32).copy() for k, v in cache.items()}
        if delta_err is not None:
            self._delta_err = {k: np.asarray(v, np.float32).copy() for k, v in delta_err.items()}

    # -- Terminate ---------------------------------------------------------------
    def terminate(self) -> None:
        """Graceful leave: upload owned partitions to the content store, hand
        off responsibility (least-loaded agents), broadcast the reassignment.
        New holders merge the uploaded value into theirs (paper §2.2)."""
        uploads: Dict[int, str] = {}
        for k, st in self.owned.items():
            cid = self.net.store.add(st.value.tobytes())
            uploads[k] = cid
        handoff = self.table.leave(self.id)
        for k, new_holder in handoff.items():
            payload = ("handoff", k, uploads[k], new_holder)
            self.net.pubsub.publish(MEMBER_TOPIC, self.id, payload, 96)
            if new_holder is not None and new_holder in _AGENTS:
                dst = _AGENTS[new_holder]
                uploaded = np.frombuffer(self.net.store.cat(uploads[k]), np.float32)
                if k in dst.owned:
                    dst.owned[k].value = 0.5 * (dst.owned[k].value + uploaded)
                else:
                    dst.owned[k] = PartitionState(value=uploaded.copy())
                    dst._subscribe_partition(k)
        for k in list(self.owned):
            self._unsubscribe_partition(k)
        self.owned.clear()
        self.live = False
        for topic in (UPDATE_TOPIC, REPLY_TOPIC, REPLICA_TOPIC, MEMBER_TOPIC, FETCH_TOPIC):
            self.net.pubsub.unsubscribe(topic, self.id)
        _AGENTS.pop(self.id, None)

    def crash(self) -> None:
        """Unexpected failure: no upload, no broadcast. Surviving replicas (or
        the checkpoint layer) must cover; the table reassigns ownership.

        The reassignment must also seed the DATA plane: ``fail()`` hands an
        orphaned partition to a new holder, and without a ``PartitionState``
        that holder drops every incoming delta (``collect`` checks
        ``k in self.owned``) and serves no replies — freezing the partition
        at stale cache values forever. Seed the new holder from a surviving
        replica when one exists, else its own cached copy, else zeros, and
        subscribe it to the partition topic."""
        handoff = self.table.fail(self.id)
        for k, new_holder in handoff.items():
            if new_holder is None or new_holder not in _AGENTS:
                continue
            dst = _AGENTS[new_holder]
            if k in dst.owned:
                continue
            val, ver = None, 0
            for h in self.table.holders_of(k):
                peer = _AGENTS.get(h)
                if peer is not None and peer.id != new_holder and k in peer.owned:
                    val = peer.owned[k].value.copy()
                    ver = peer.owned[k].version  # stay mergeable with survivors
                    break
            if val is None:
                cached = dst.cache.pop(k, None)
                val = (
                    cached.astype(np.float32).copy()
                    if cached is not None
                    else np.zeros(self.spec.sizes[k], np.float32)
                )
            # fresh eps; version 0 is safe here — an orphaned partition has
            # no surviving co-holders whose publishes we could lag behind
            dst.owned[k] = PartitionState(value=val, version=ver)
            dst._subscribe_partition(k)
        for k in list(self.owned):
            self._unsubscribe_partition(k)
        self.owned.clear()
        self.live = False
        _AGENTS.pop(self.id, None)


# registry used by the in-process simulation to resolve peers (stands in for
# the DHT lookup of agent addresses in real IPFS)
_AGENTS: Dict[int, IPLSAgent] = {}


def reset_registry() -> None:
    _AGENTS.clear()


def register(agent: IPLSAgent) -> None:
    _AGENTS[agent.id] = agent


def lookup(agent_id: int) -> Optional[IPLSAgent]:
    return _AGENTS.get(agent_id)
