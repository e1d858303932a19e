"""Port of ``repro.data``: synthetic datasets and federated partitions."""
from repro_torch.data.partition import (
    dirichlet_sizes,
    partition_dirichlet,
    partition_dirichlet_mixed,
    partition_dirichlet_sized,
    partition_iid,
    partition_noniid_shards,
)
from repro_torch.data.synthetic import make_classification_dataset, make_token_dataset

__all__ = [
    "dirichlet_sizes",
    "make_classification_dataset",
    "make_token_dataset",
    "partition_dirichlet",
    "partition_dirichlet_mixed",
    "partition_dirichlet_sized",
    "partition_iid",
    "partition_noniid_shards",
]
