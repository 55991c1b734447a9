"""Label-shard non-IID partition, paper §IV (PyTorch port of
``repro.fl.partition.shard_partition``).

Sort by label -> equal shards -> each user gets ``shards_per_user`` random
shards.  The tail truncation that keeps every |D_i| equal is spread evenly
over the label-sorted order, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng


def shard_partition(key: torch.Tensor, labels: torch.Tensor, n_users: int,
                    shards_per_user: int = 2) -> torch.Tensor:
    """[n_users, samples_per_user] int64 index matrix into the dataset."""
    n = labels.shape[0]
    n_shards = n_users * shards_per_user
    shard_size = n // n_shards
    if shard_size == 0:
        raise ValueError(f"dataset of {n} too small for {n_shards} shards")
    order = torch.argsort(labels, stable=True)
    n_keep = n_shards * shard_size
    # host-side exact integer spread: position i keeps sorted sample
    # floor(i * n / n_keep); identity when n == n_keep
    keep = np.arange(n_keep) * n // n_keep
    order = order[torch.as_tensor(keep, device=labels.device)]
    shards = order.reshape(n_shards, shard_size)
    perm = rng.permutation(key, n_shards)
    return shards[perm.long()].reshape(n_users, shards_per_user * shard_size)
