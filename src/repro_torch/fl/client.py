"""Client-side local training: E epochs of minibatch SGD (PyTorch port of
``repro.fl.client``).

The whole fleet trains in one batched loop over (epoch, batch): every
parameter leaf carries a leading ``[N]`` client axis, and one backward pass
of the summed per-client mean losses gives each client exactly its own
gradient (the clients share no parameter), which is what ``vmap(grad)``
computes in the JAX package.  With ``compute="full"`` unscheduled clients
train too and the mask only enters the Eq. (2) aggregation; with
``compute="selected"`` the round engine first gathers a static-size
padded subset of scheduled clients (:func:`topk_selected_indices`) and
trains only those rows, so per-client learning state is ``[cap, model]``
and not ``[N, model]``.

Client i's epoch-e batches come from
``permutation(split(key_i, epochs)[e], n_i)[:n_used]``, as in the JAX
package, so both packages visit the same samples in the same order.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import rng
from repro_torch.launch.sharding import (pad_leading, padded_count,
                                         unpad_leading)
from repro_torch.models import cnn
from repro_torch.tree import Params, tree_leaves, tree_map, tree_unflatten


def resolve_cap(n: int, select_cap: int | None) -> int:
    """Static gather width for ``compute="selected"``: ``select_cap``
    clamped to the fleet size, or the whole fleet when unset."""
    return n if select_cap is None else min(int(select_cap), n)


def topk_selected_indices(selected: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] client indices, every selected client first in index order,
    unselected ones padding the tail (their Eq. (2) weight is 0).

    A cap that covers the selection reproduces the full-fleet result; a
    smaller one drops the selected clients past it from the round.  The
    stable sort of the negated mask gives the JAX package's indices
    exactly."""
    order = torch.argsort((~selected.bool()).to(torch.int8), stable=True)
    return order[:cap]


def gather_client_tree(tree: Params, idx: torch.Tensor) -> Params:
    """Rows ``idx`` of every leaf: ``[len(idx), ...]`` (e.g. each client's
    serving edge model out of the ``[M, ...]`` edge models)."""
    return tree_map(lambda a: a[idx.long()], tree)



def scatter_client_tree(n: int, idx: torch.Tensor, tree: Params,
                        base: Params | None = None) -> Params:
    """Rows of ``tree`` (leaves [R, ...]) back to client-indexed [n, ...]
    leaves: row r lands at client ``idx[r]``, on top of ``base`` when
    given, zeros otherwise.  A negative index counts from the end; an
    index outside [-n, n) is dropped (the ``n`` sentinel of an empty
    queue slot).  Dropped rows are redirected to a scratch row n that is
    cut off afterwards, so no index ever leaves the tensor (a device-side
    assert on CUDA) and the host never waits on the mask."""
    idx = idx.long()
    keep = (idx >= -n) & (idx < n)
    dst = torch.where(keep, torch.remainder(idx, n), n)

    def put(b, a):
        scratch = torch.zeros((1,) + tuple(b.shape[1:]), dtype=b.dtype,
                              device=b.device)
        out = torch.cat([b, scratch]).index_put_((dst,), a.to(b.dtype))
        return out[:n]

    if base is None:
        return tree_map(lambda a: put(
            torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device), a), tree)
    return tree_map(put, base, tree)


def fleet_local_sgd(global_params: Params, x_all: torch.Tensor,
                    y_all: torch.Tensor, keys: torch.Tensor, epochs: int,
                    batch_size: int, lr: float,
                    losses: Callable = cnn.client_losses,
                    mesh=None) -> Params:
    """E epochs of SGD on every client, all starting from ``global_params``
    (broadcast into :func:`fleet_local_sgd_per_client`)."""
    n_clients = x_all.shape[0]
    init = tree_map(
        lambda g: g.detach()[None].repeat((n_clients,) + (1,) * g.dim()),
        global_params)
    return fleet_local_sgd_per_client(init, x_all, y_all, keys, epochs,
                                      batch_size, lr, losses, mesh=mesh)


def fleet_local_sgd_per_client(init_params: Params, x_all: torch.Tensor,
                               y_all: torch.Tensor, keys: torch.Tensor,
                               epochs: int, batch_size: int, lr: float,
                               losses: Callable = cnn.client_losses,
                               mesh=None) -> Params:
    """E epochs of SGD on every client, client i starting from row i of
    ``init_params`` (leaves [N, ...]; the hierarchical engine's serving
    edge models).

    x_all [N, n_i, ...], y_all [N, n_i], keys [N, 2].  Returns the client
    models, leaves [N, ...].  ``losses(params, x, y) -> [N]`` is each
    client's mean loss on its batch.  With a ``mesh`` of more than one
    rank (:class:`repro_torch.launch.mesh.DataMesh`, ``FLConfig.shard``)
    the rows pad to a multiple of the mesh size, each rank trains its
    block and one all-gather returns every row to every rank.
    """
    if mesh is not None and mesh.world_size > 1:
        return _sharded_sgd(mesh, init_params, x_all, y_all, keys, epochs,
                            batch_size, lr, losses)
    n_clients, n = x_all.shape[0], x_all.shape[1]
    n_batches = n // batch_size
    if n_batches == 0:
        raise ValueError(
            f"batch_size={batch_size} exceeds the {n} samples per client — "
            f"local SGD would silently train nothing; shrink batch_size or "
            f"grow n_train/shards")
    n_used = n_batches * batch_size
    params = tree_map(lambda p: p.detach(), init_params)
    ekeys = rng.split(keys, epochs)                        # [N, E, 2]
    rows = torch.arange(n_clients, device=x_all.device)[:, None]
    for e in range(epochs):
        perm = rng.permutation(ekeys[:, e], n)[:, :n_used].long()
        xb = x_all[rows, perm].reshape(
            (n_clients, n_batches, batch_size) + tuple(x_all.shape[2:]))
        yb = y_all[rows, perm].reshape(n_clients, n_batches, batch_size)
        for b in range(n_batches):
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            loss = losses(params, xb[:, b], yb[:, b]).sum()
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                params = tree_unflatten(
                    params, [p - lr * g for p, g in zip(leaves, grads)])
    return params


def _sharded_sgd(mesh, init_params: Params, x_all, y_all, keys, epochs,
                 batch_size, lr, losses) -> Params:
    """:func:`fleet_local_sgd_per_client` split over ``mesh``: rank r
    trains rows ``[r b, (r + 1) b)`` of the rows padded by
    :func:`~repro_torch.launch.sharding.pad_leading` to ``D b``, and one
    all-gather of the trained rows, flattened to [b, P] float32, returns
    the [N, ...] client models.  A client's SGD reads only its own row, so
    each row is what the unsharded fleet computes, up to the rounding of
    the batched matmuls, which may move with the rows trained at once."""
    n_clients = x_all.shape[0]
    n_pad = padded_count(n_clients, mesh.size)
    b = n_pad // mesh.size
    like = tree_leaves(init_params)
    sizes = [leaf[0].numel() for leaf in like]
    if mesh.rank < mesh.size:
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        init, x_r, y_r, k_r = (tree_map(lambda a: a[rows], t) for t in
                               pad_leading((init_params, x_all, y_all, keys),
                                           n_pad))
        trained = tree_leaves(fleet_local_sgd_per_client(
            init, x_r, y_r, k_r, epochs, batch_size, lr, losses))
        flat = torch.cat([leaf.reshape(b, -1).float() for leaf in trained],
                         dim=1)
    else:                             # takes no rows, joins the gather
        flat = torch.zeros((b, sum(sizes)), device=x_all.device)
    flat = unpad_leading(mesh.gather_rows(flat), n_clients)
    return tree_unflatten(init_params, [
        part.reshape(leaf.shape).to(leaf.dtype)
        for part, leaf in zip(flat.split(sizes, dim=1), like)])


def local_sgd(params: Params, x: torch.Tensor, y: torch.Tensor,
              key: torch.Tensor, epochs: int, batch_size: int,
              lr: float) -> Params:
    """E epochs of minibatch SGD on ONE client's data (x [n_i, ...])."""
    out = fleet_local_sgd(params, x[None], y[None], key[None], epochs,
                          batch_size, lr)
    return tree_map(lambda p: p[0], out)
