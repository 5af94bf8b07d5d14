from repro_torch.p2p.ipfs_sim import ContentStore, PubSub, SimIPFS
from repro_torch.p2p.network import LOSSY, PERFECT, NetworkConditions

__all__ = [
    "ContentStore",
    "PubSub",
    "SimIPFS",
    "NetworkConditions",
    "PERFECT",
    "LOSSY",
]
