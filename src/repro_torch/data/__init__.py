"""Synthetic data, client partitions and the round batch pipeline (numpy)."""
from .synthetic import make_image_dataset, make_lm_dataset
from .partition import (
    partition_iid,
    partition_primary_label,
    partition_dirichlet,
    split_local_test,
)
from .pipeline import ClientStore, lm_client_batches

__all__ = [
    "make_image_dataset",
    "make_lm_dataset",
    "partition_iid",
    "partition_primary_label",
    "partition_dirichlet",
    "split_local_test",
    "ClientStore",
    "lm_client_batches",
]
