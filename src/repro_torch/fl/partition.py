"""Non-IID partitioners (PyTorch port of ``repro.fl.partition``): the
paper's label shards (§IV) and a per-user Dirichlet class mixture.

``shard_partition``: sort by label -> equal shards -> each user gets
``shards_per_user`` random shards; the tail truncation that keeps every
|D_i| equal is spread evenly over the label-sorted order, as in the JAX
package.  ``dirichlet_partition``: each user draws class proportions from
Dir(alpha) and a fixed-size local dataset from them, with replacement
(small alpha: a few classes a user; large alpha: IID).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng

PARTITION_KINDS = ("shard", "dirichlet")


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


def dirichlet_partition(key: torch.Tensor, labels: torch.Tensor,
                        n_users: int, samples_per_user: int, alpha: float,
                        n_classes: int = 10) -> torch.Tensor:
    """[n_users, samples_per_user] int64 index matrix into the dataset.

    User i draws class proportions p_i ~ Dir(alpha 1_C) (``k_prop``), then
    ``samples_per_user`` indices with replacement, sample j weighted by
    p_i[label_j]: a categorical over the dataset per user, with user i's
    key ``split(k_draw, n_users)[i]``, as the JAX package draws them."""
    if samples_per_user <= 0:
        raise ValueError(f"samples_per_user must be positive, "
                         f"got {samples_per_user}")
    k_prop, k_draw = rng.split(key).unbind(0)
    alphas = torch.full((n_classes,), float(alpha), dtype=torch.float32,
                        device=key.device)
    props = rng.dirichlet(k_prop, alphas, (n_users,))
    # per-user log weight of each SAMPLE: its class's mass
    logits = torch.log(torch.clamp(props[:, labels.long()], min=1e-30))
    draw_keys = rng.split(k_draw, n_users)
    return rng.categorical(draw_keys, logits, (samples_per_user,)).long()
