"""IPLS partition assignment (paper §2.1, "Model partitioning and distribution").

The global parameter vector W is split into K partitions. Every agent is
responsible for at least ``pi`` partitions; every partition is replicated at
most ``rho`` times. Assignment follows the paper's rule: a joining agent takes
partitions from the agent that currently stores the most partitions
(max-overloaded), preferring the least-replicated partitions; ties broken
deterministically by partition id.

Counterpart of ``repro.core.partition``: pure Python/numpy bookkeeping, the
control plane. ``unflatten_params`` also slices torch tensors, with any
leading batch dimensions, so the batched engine trains on views of one
(A, N) weight matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

AgentId = int
PartitionId = int


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Static description of how W is split into K partitions.

    ``sizes[k]`` is the number of scalar parameters in partition k. Partitions
    are contiguous ranges of the flattened parameter vector, in order.
    """

    sizes: Tuple[int, ...]

    @property
    def num_partitions(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        return int(sum(self.sizes))

    def offsets(self) -> Tuple[int, ...]:
        # memoized: update_model/load_model call this on every round; the
        # frozen dataclass still has a __dict__, so plain item assignment
        # caches without tripping the frozen __setattr__.
        cached = self.__dict__.get("_offsets")
        if cached is not None:
            return cached
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        self.__dict__["_offsets"] = tuple(out)
        return self.__dict__["_offsets"]

    @staticmethod
    def even(total: int, k: int) -> "PartitionSpec":
        """Split ``total`` parameters into ``k`` near-equal partitions."""
        if k <= 0:
            raise ValueError("k must be positive")
        base, rem = divmod(total, k)
        sizes = tuple(base + (1 if i < rem else 0) for i in range(k))
        return PartitionSpec(sizes=sizes)


class PartitionTable:
    """Mutable responsibility table: which agent stores which partition.

    Invariants (checked by ``validate``):
      * every live agent stores >= min(pi, K) partitions (pi clamped to K);
      * every partition is stored by <= rho agents;
      * every partition is stored by >= 1 agent whenever any agent is live.
    """

    def __init__(self, num_partitions: int, pi: int, rho: int):
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        if pi <= 0 or rho <= 0:
            raise ValueError("pi and rho must be positive")
        self.k = num_partitions
        self.pi = min(pi, num_partitions)
        self.rho = rho
        # partition -> ordered list of responsible agents
        self._holders: Dict[PartitionId, List[AgentId]] = {
            p: [] for p in range(num_partitions)
        }
        self._agents: Dict[AgentId, List[PartitionId]] = {}

    # -- queries ----------------------------------------------------------
    @property
    def agents(self) -> List[AgentId]:
        return sorted(self._agents)

    def partitions_of(self, agent: AgentId) -> List[PartitionId]:
        return list(self._agents.get(agent, []))

    def holders_of(self, partition: PartitionId) -> List[AgentId]:
        return list(self._holders[partition])

    def replication(self, partition: PartitionId) -> int:
        return len(self._holders[partition])

    def load(self, agent: AgentId) -> int:
        return len(self._agents.get(agent, ()))

    def coverage(self) -> bool:
        """True iff every partition has at least one live holder."""
        return all(len(h) > 0 for h in self._holders.values())

    # -- membership -------------------------------------------------------
    def bootstrap(self, agent: AgentId) -> List[PartitionId]:
        """First agent: stores ALL partitions (paper: 'the agent that
        initiated the training process stores all the partitions')."""
        if self._agents:
            raise RuntimeError("bootstrap() on a non-empty table")
        self._agents[agent] = list(range(self.k))
        for p in range(self.k):
            self._holders[p].append(agent)
        return self.partitions_of(agent)

    def join(self, agent: AgentId) -> List[PartitionId]:
        """Paper's join rule. The new agent acquires up to ``pi`` partitions:

        repeatedly take one partition from the most-overloaded donor
        (an agent with load > pi), choosing the donor's least-replicated
        partition — *transferring* responsibility. If no donor can give one
        up, *replicate* the globally least-replicated partition, as long as
        its replication < rho. An agent that cannot reach pi partitions keeps
        whatever it got (possibly none, matching the paper's example where
        late joiners store nothing once all partitions hit rho).
        """
        if agent in self._agents:
            raise ValueError(f"agent {agent} already joined")
        self._agents[agent] = []
        for _ in range(self.pi):
            if not self._take_one(agent):
                break
        return self.partitions_of(agent)

    def _take_one(self, agent: AgentId) -> bool:
        mine = set(self._agents[agent])
        # 1) transfer from the most-overloaded donor (load > pi)
        donors = [a for a in self._agents if a != agent and self.load(a) > self.pi]
        donors.sort(key=lambda a: (-self.load(a), a))
        for donor in donors:
            cands = [p for p in self._agents[donor] if p not in mine]
            if not cands:
                continue
            # least-replicated first, then lowest id
            cands.sort(key=lambda p: (self.replication(p), p))
            p = cands[0]
            self._agents[donor].remove(p)
            self._holders[p].remove(donor)
            self._attach(agent, p)
            return True
        # 2) replicate the least-replicated partition under rho
        cands = [
            p
            for p in range(self.k)
            if p not in mine and self.replication(p) < self.rho
        ]
        if not cands:
            return False
        cands.sort(key=lambda p: (self.replication(p), p))
        self._attach(agent, cands[0])
        return True

    def _attach(self, agent: AgentId, p: PartitionId) -> None:
        self._agents[agent].append(p)
        self._agents[agent].sort()
        self._holders[p].append(agent)

    def leave(self, agent: AgentId) -> Dict[PartitionId, Optional[AgentId]]:
        """Paper's Terminate(): hand off each partition this agent held to the
        least-loaded other agent not already holding it. Returns the handoff
        map partition -> new holder (None if the partition would be orphaned
        and no eligible agent exists — then it is given to the least-loaded
        agent regardless of rho to preserve coverage, or truly orphaned if no
        agents remain).
        """
        if agent not in self._agents:
            raise ValueError(f"agent {agent} not present")
        held = self._agents.pop(agent)
        handoff: Dict[PartitionId, Optional[AgentId]] = {}
        for p in held:
            self._holders[p].remove(agent)
            if self._holders[p]:
                handoff[p] = None  # still replicated; no handoff needed
                continue
            # orphaned: assign to least-loaded agent (coverage beats rho)
            others = sorted(self._agents, key=lambda a: (self.load(a), a))
            if not others:
                handoff[p] = None
                continue
            new_holder = others[0]
            self._attach(new_holder, p)
            handoff[p] = new_holder
        return handoff

    def fail(self, agent: AgentId) -> Dict[PartitionId, Optional[AgentId]]:
        """Unexpected failure: same reassignment as leave(), but semantically
        the data-plane must recover partition values from replicas (or from
        the last checkpoint when replication was 1)."""
        return self.leave(agent)

    # -- validation -------------------------------------------------------
    def validate(self) -> None:
        for p, holders in self._holders.items():
            if len(holders) != len(set(holders)):
                raise AssertionError(f"duplicate holders for partition {p}")
            if len(holders) > max(self.rho, 1) and len(self._agents) > 1:
                # rho may be exceeded only transiently by coverage-preserving
                # handoff; flag everything else.
                raise AssertionError(
                    f"partition {p} over-replicated: {len(holders)} > rho={self.rho}"
                )
        for a, parts in self._agents.items():
            for p in parts:
                if a not in self._holders[p]:
                    raise AssertionError(f"table inconsistent for agent {a}, part {p}")
        if self._agents and not self.coverage():
            # coverage can only break when every agent left
            raise AssertionError("partition coverage lost while agents remain")

    def as_lookup(self) -> Dict[PartitionId, List[AgentId]]:
        """The paper's 'lookup table': partition -> responsible agents."""
        return {p: list(h) for p, h in self._holders.items()}


def flatten_params(params) -> Tuple[np.ndarray, List[Tuple[str, Tuple[int, ...]]]]:
    """Flatten a pytree-like dict of numpy arrays into one vector + layout."""
    layout: List[Tuple[str, Tuple[int, ...]]] = []
    chunks: List[np.ndarray] = []

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(f"{prefix}/{key}" if prefix else str(key), node[key])
        else:
            arr = np.asarray(node)
            layout.append((prefix, arr.shape))
            chunks.append(arr.reshape(-1))

    walk("", params)
    if not chunks:
        return np.zeros((0,), np.float32), layout
    return np.concatenate(chunks), layout


def unflatten_params(vec, layout: Sequence[Tuple[str, Tuple[int, ...]]]):
    """Inverse of flatten_params (returns nested dict). ``vec`` is a numpy
    array or a torch tensor of shape (..., N); leaves get shape
    (..., *shape) and are views of ``vec`` where the layout allows."""
    out: Dict = {}
    off = 0
    lead = tuple(vec.shape[:-1])
    for name, shape in layout:
        size = int(np.prod(shape)) if shape else 1
        arr = vec[..., off : off + size].reshape(lead + tuple(shape))
        off += size
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out
