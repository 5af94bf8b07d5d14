"""IPLS core: the paper's contribution (host control plane, numpy).

  partition.py    control plane — pi/rho partition assignment, join/leave
  wire.py         wire codecs (f32, block-int8) and their byte counts
  api.py          the middleware API: Init/UpdateModel/LoadModel/Terminate
"""
from repro_torch.core.api import IPLSAgent, reset_registry
from repro_torch.core.partition import (
    PartitionSpec,
    PartitionTable,
    flatten_params,
    unflatten_params,
)

__all__ = [
    "PartitionSpec",
    "PartitionTable",
    "flatten_params",
    "unflatten_params",
    "IPLSAgent",
    "reset_registry",
]
