from repro_torch.fl.centralized import run_centralized
from repro_torch.fl.gossip import run_gossip
from repro_torch.fl.local_trainer import LocalTrainer
from repro_torch.fl.rounds import IPLSSimulation, SimConfig, make_simulation

__all__ = [
    "LocalTrainer",
    "run_centralized",
    "IPLSSimulation",
    "SimConfig",
    "make_simulation",
    "run_gossip",
]
