"""Synthetic datasets, Dirichlet partitions, per-client batch sources and
bulk staging (the names `repro.data` exports)."""
from repro_torch.data.loader import ClientLoader, batch_iterator
from repro_torch.data.partition import ClientData, assign_clusters, dirichlet_partition
from repro_torch.data.sources import ArraySource, DataSource, TokenSource
from repro_torch.data.synthetic import DATASETS, Dataset, make_dataset
from repro_torch.data.tokens import synthetic_lm_batch

__all__ = [
    "make_dataset",
    "DATASETS",
    "Dataset",
    "dirichlet_partition",
    "assign_clusters",
    "ClientData",
    "ClientLoader",
    "batch_iterator",
    "DataSource",
    "ArraySource",
    "TokenSource",
    "synthetic_lm_batch",
]
