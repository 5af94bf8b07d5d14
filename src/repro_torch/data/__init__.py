from repro_torch.data.federated_split import dirichlet_split, iid_split
from repro_torch.data.pipeline import FederatedDataset, batch_iterator
from repro_torch.data.synthetic import synth_mnist, synth_tokens

__all__ = [
    "synth_mnist",
    "synth_tokens",
    "iid_split",
    "dirichlet_split",
    "batch_iterator",
    "FederatedDataset",
]
