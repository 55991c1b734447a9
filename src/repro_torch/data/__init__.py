"""Data substrate: synthetic datasets and the token pipeline (PyTorch port
of ``repro.data``)."""
from repro_torch.data.synthetic import DATASETS, Dataset, make_dataset
from repro_torch.data.tokens import token_batches

__all__ = ["DATASETS", "make_dataset", "Dataset", "token_batches"]
