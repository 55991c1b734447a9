"""Tensor-parallel execution of the LM over a ``("data", "model")`` mesh
of ranks: what JAX's SPMD partitioner does for
:mod:`repro_torch.launch.sharding`'s specs (port-only).

JAX places a model by its specs and XLA inserts the collectives.  The
port runs one process a rank (:class:`repro_torch.launch.mesh.Mesh`), so
this module does that work by hand for the dense attention family
(qwen3, deepseek-67b, olmo):

* :func:`local_config` is the config a rank runs: ``n_heads / m``,
  ``n_kv_heads / m`` and ``d_ff / m`` for a model axis of ``m``, the head
  width pinned (``head_dim`` would fall back to ``d_model // n_heads``),
  the vocab and its padding kept whole, so each rank's vocab shard is its
  block of the padded table.  It carries the mesh, so every hook below
  finds it through ``cfg``.
* :func:`shard_leaf` / :func:`shard_params` keep a rank's contiguous
  block of a leaf along the dim its spec names ``"model"``;
  ``lm.init_params`` of a local config draws the whole model's numbers a
  layer at a time and keeps only the rank's blocks.
* The collectives, each the identity for a config without a mesh or on a
  model axis of 1, so every unsharded, captured or CPU path is unchanged:
  :func:`row_matmul` sums the row-parallel ``@ wo`` / ``@ down`` partial
  products over the model group in float32 and rounds once to the
  activation dtype; :func:`embed` is the vocab-parallel lookup (a rank
  gathers its own rows, zeros the others, and the group sums: exactly one
  rank adds a non-zero row, so the sum is exact); :func:`vocab_offset`
  places a rank's vocab-sharded logits ``x @ table_local.T``, whose pad
  ids are masked by their global index; :func:`greedy` is the argmax over
  the shards, the lowest index on ties as ``torch.argmax``;
  :func:`gather_logits` assembles the whole vocab.
* The batch: :func:`batch_rows` / :func:`gather_rows` split and join the
  leading dim over the data axis as ``batch_pspecs`` says.

JAX's column rule shards ``wk`` whenever the axis divides ``KV * dh``, which
can split one head across devices: XLA reshards that, a rank's local
attention cannot, so :func:`local_config` refuses a model axis that does
not divide ``n_kv_heads``.  The rules themselves stay JAX's, leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.launch import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LocalConfig(ModelConfig):
    """One rank's share of ``full`` on ``mesh`` (see :func:`local_config`;
    build it there, not by hand)."""

    mesh: Any = None
    full: Optional[ModelConfig] = None


def local_config(cfg: ModelConfig, mesh) -> LocalConfig:
    """The config a rank of ``mesh`` runs for ``cfg``; ValueError for a
    config outside the dense attention family or a model axis that does
    not divide its KV heads, heads, ``d_ff`` or padded vocab."""
    m = sharding.axis_sizes(mesh)["model"]
    if (cfg.arch_type != "dense" or cfg.attention != "gqa" or cfg.is_moe
            or cfg.encoder_decoder or cfg.frontend):
        raise ValueError(
            f"{cfg.name}: the tensor-parallel executor serves the dense "
            f"attention family (arch_type 'dense', GQA attention), not "
            f"arch_type {cfg.arch_type!r} / attention {cfg.attention!r}")
    if cfg.n_kv_heads % m:
        raise ValueError(
            f"{cfg.name}: a model axis of {m} does not divide n_kv_heads = "
            f"{cfg.n_kv_heads}; JAX's column rule would split a head across "
            f"ranks, which a rank's local attention cannot run")
    for what, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                    ("the padded vocab", cfg.padded_vocab)):
        if n % m:
            raise ValueError(f"{cfg.name}: a model axis of {m} does not "
                             f"divide {what} = {n}")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
                  d_ff=cfg.d_ff // m, d_head=cfg.head_dim)
    return LocalConfig(**fields, mesh=mesh, full=cfg)


def _model_mesh(cfg):
    """The mesh of a local config whose model axis is above 1, else
    None."""
    mesh = getattr(cfg, "mesh", None)
    return mesh if mesh is not None and mesh.model > 1 else None


# ----------------------------------------------------------------- leaves --
def _block(leaf: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The rank's contiguous block of ``leaf`` along each dim ``spec``
    names ``"model"`` (a view)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if entry != "model":
            raise ValueError(f"a parameter spec shards over {entry!r}; "
                             f"only 'model' is a parameter axis")
        n = leaf.shape[dim] // mesh.model
        leaf = leaf.narrow(dim, mesh.model_rank * n, n)
    return leaf


def shard_leaf(path: tuple, leaf: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's block of the parameter at ``path`` (dict keys from the
    root, as ``sharding.param_pspecs`` names them), a view of ``leaf``."""
    return _block(leaf, sharding._rule(tuple(path), tuple(leaf.shape),
                                       mesh.model), mesh)


def shard_params(params, mesh):
    """The rank's blocks of a whole parameter tree (copies)."""
    specs = sharding.param_pspecs(None, params, mesh)
    return tree_map(lambda w, s: _block(w, s, mesh).contiguous(), params,
                    specs)


def draw_plan(cfg) -> tuple[ModelConfig, Optional[Callable]]:
    """(the config whose numbers an init draws, ``shard(path, leaf)`` that
    keeps a rank's block, or None to keep every leaf whole)."""
    if not isinstance(cfg, LocalConfig):
        return cfg, None
    mesh = _model_mesh(cfg)
    return cfg.full, (None if mesh is None
                      else functools.partial(shard_leaf, mesh=mesh))


# ------------------------------------------------------------ collectives --
def row_matmul(cfg, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a row-parallel ``w`` (``wo``, ``down``): each rank's
    partial product in float32, summed over the model group, rounded once
    to ``x``'s dtype."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return x @ w
    return mesh.model_sum(x.float() @ w.float()).to(x.dtype)


def embed(cfg, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` of a vocab-sharded table: the rank's own rows, the
    others zero, summed over the model group (exact: one rank a token
    adds a non-zero row)."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return table[tokens.long()]
    rows = table.shape[0]
    local = tokens.long() - mesh.model_rank * rows
    mine = ((local >= 0) & (local < rows))[..., None]
    part = torch.where(mine, table[local.clamp(0, rows - 1)].float(), 0.0)
    return mesh.model_sum(part).to(table.dtype)


def vocab_offset(cfg, rows: int) -> int:
    """The global id of a rank's first vocab row (of ``rows``)."""
    mesh = _model_mesh(cfg)
    return 0 if mesh is None else mesh.model_rank * rows


def greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    """[B, 1] int64: the argmax over the real vocab of logits [B, V] (a
    rank's shard under a mesh), the lowest id on ties."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None]
    rows = logits.shape[-1]
    lo = mesh.model_rank * rows
    n = min(max(cfg.vocab - lo, 0), rows)
    if n:
        idx = torch.argmax(logits[:, :n], dim=-1)
        val = logits[:, :n].gather(-1, idx[:, None])[:, 0].double()
    else:               # the shard holds pad ids only
        idx = torch.zeros(logits.shape[0], dtype=torch.long,
                          device=logits.device)
        val = torch.full_like(idx, float("-inf"), dtype=torch.float64)
    pairs = mesh.model_gather(torch.stack([val, (idx + lo).double()], -1))
    first = pairs[..., 0].argmax(dim=0)       # the lowest rank of the max
    return pairs[..., 1].gather(0, first[None])[0].long()[:, None]


def gather_logits(cfg, logits: torch.Tensor) -> torch.Tensor:
    """The whole padded vocab's logits from each rank's shard (the last
    dim), on every rank of the model group."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return logits
    return torch.cat(list(mesh.model_gather(logits).unbind(0)), dim=-1)


# ------------------------------------------------------------------ batch --
def batch_rows(cfg, batch, mesh):
    """The rank's rows of a batch tree as ``batch_pspecs`` places them:
    the data rank's contiguous block of a leading dim that divides over
    ``data``, every row of one that does not."""
    if mesh is None:
        return batch
    specs = sharding.batch_pspecs(cfg, batch, mesh)

    def rows(leaf, spec):
        if spec[0] is None:
            return leaf
        n = leaf.shape[0] // mesh.data
        return leaf[mesh.data_rank * n:(mesh.data_rank + 1) * n]

    return tree_map(rows, batch, specs)


def gather_rows(cfg, t: torch.Tensor, n_rows: int, mesh) -> torch.Tensor:
    """The whole batch of ``t``, the rank's rows of an ``n_rows`` batch as
    :func:`batch_rows` took them, on every rank."""
    if mesh is None:
        return t
    spec = sharding.batch_pspecs(
        cfg, torch.empty((n_rows,), device="meta"), mesh)
    if spec[0] is None:
        return t
    return torch.cat(list(mesh.data_gather(t).unbind(0)))
