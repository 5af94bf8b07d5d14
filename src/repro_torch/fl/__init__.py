from repro_torch.fl.local_trainer import LocalTrainer
from repro_torch.fl.rounds import IPLSSimulation, SimConfig, make_simulation

__all__ = ["LocalTrainer", "IPLSSimulation", "SimConfig", "make_simulation"]
