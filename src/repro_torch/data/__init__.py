from repro_torch.data.federated_split import dirichlet_split, iid_split
from repro_torch.data.synthetic import synth_mnist

__all__ = ["synth_mnist", "iid_split", "dirichlet_split"]
