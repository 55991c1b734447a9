"""Optimizers as transforms of parameter trees (PyTorch port of
``repro.optim.optimizers``).

The API is JAX's, optax's shape: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, new_state)``, then
:func:`apply_updates`.  Trees are the port's nested dicts and lists of
tensors (:mod:`repro_torch.tree`); nothing is updated in place, so a
caller may keep the old parameters.  The arithmetic follows the JAX
code's order, operation by operation, so float32 results agree; the
step count is an int32 tensor on the parameters' device, as in JAX, so a
schedule never leaves the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _device(tree: PyTree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (leaf by leaf, in tree order, as JAX's Python ``sum``)."""
    total = torch.zeros((), dtype=torch.float32, device=_device(tree))
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _scaled(s, x: torch.Tensor) -> torch.Tensor:
    """``s * x`` under JAX's promotion: a float32 tensor ``s`` lifts a
    bfloat16 ``x`` to float32 (torch would keep a 0-d operand's dtype out
    of the promotion), a Python float (JAX's weak type) keeps x's dtype."""
    if isinstance(s, torch.Tensor):
        return s * x.to(torch.promote_types(x.dtype, s.dtype))
    return s * x


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: _scaled(scale, x), tree)


def _lr_at(lr, count: torch.Tensor):
    """The step's learning rate: a schedule's float32 tensor, or the
    constant as a Python float (JAX's weakly typed ``jnp.asarray(lr)``)."""
    return lr(count) if callable(lr) else float(lr)


# ------------------------------------------------------------------- SGD ---
class SGDState(NamedTuple):
    momentum: PyTree
    count: torch.Tensor


def sgd(lr: float | Callable[[torch.Tensor], torch.Tensor],
        momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum.  The paper uses lr=0.01,
    plain."""

    def init(params):
        return SGDState(momentum=tree_map(torch.zeros_like, params),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=_device(params)))

    def update(grads, state, params=None):
        del params
        if momentum == 0.0:
            new_m = state.momentum
            direction = grads
        else:
            new_m = tree_map(lambda m, g: momentum * m + g, state.momentum,
                             grads)
            direction = (tree_map(lambda m, g: momentum * m + g, new_m,
                                  grads) if nesterov else new_m)
        step = _lr_at(lr, state.count)
        updates = tree_map(lambda d: _scaled(-step, d), direction)
        return updates, SGDState(momentum=new_m, count=state.count + 1)

    return Optimizer(init=init, update=update)


# ----------------------------------------------------------------- AdamW ---
class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with bias correction and decoupled weight decay; the moments
    are float32 whatever the parameters' dtype.  Each update is
    ``-lr (mhat / (sqrt(vhat) + eps) + wd p)``, cast to the leaf's
    dtype."""

    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=_device(params)))

    def update(grads, state, params):
        count = state.count + 1
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                      state.nu, g32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=count.device), count.float())
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=count.device), count.float())
        step = _lr_at(lr, state.count)

        def upd(m, v, p):
            mhat = m / c1
            vhat = v / c2
            u = -step * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.float())
            return u.to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(mu=mu, nu=nu, count=count)

    return Optimizer(init=init, update=update)


# -------------------------------------------------------------- schedules --
def cosine_warmup_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           final_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac`` of it at ``total_steps``; a function of the
    step count (a tensor) to a float32 tensor."""
    def sched(count: torch.Tensor) -> torch.Tensor:
        count = count.float()
        warm = peak_lr * count / max(warmup_steps, 1)
        frac = torch.clamp((count - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(count < warmup_steps, warm, peak_lr * cos)

    return sched
