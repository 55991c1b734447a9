"""Tensor-parallel execution of the LM over a ``("data", "model")`` mesh
of ranks: what JAX's SPMD partitioner does for
:mod:`repro_torch.launch.sharding`'s specs (port-only).

JAX places a model by its specs and XLA inserts the collectives.  The
port runs one process a rank (:class:`repro_torch.launch.mesh.Mesh`), so
this module does that work by hand for all ten configs: the dense family
(qwen3, deepseek-67b, olmo), the VLM (qwen2-vl), the MoE configs
(qwen3-moe; deepseek-v2 with MLA), the SSM and hybrid configs (mamba2;
zamba2, whose shared attention block splits as a dense block) and the
encoder-decoder (whisper):

* :func:`local_config` is the config a rank runs: ``n_heads / m``,
  ``n_kv_heads / m``, ``d_ff / m`` and ``d_ff_dense / m`` for a model
  axis of ``m``, the head width pinned (``head_dim`` would fall back to
  ``d_model // n_heads``), the vocab and its padding kept whole, so each
  rank's vocab shard is its block of the padded table; the experts and
  their width kept whole, since every rank routes over all of them; an
  attention-free config's head fields and every SSM field whole, since
  JAX's rule replicates the SSM leaves and every model rank runs the
  whole Mamba2 layer on the same rows.  It carries the mesh, so every
  hook below finds it through ``cfg``.
* :func:`placement` / :func:`shard_leaf` / :func:`shard_params` keep a
  rank's contiguous block of a leaf along the dim its spec names
  ``"model"``; ``lm.init_params`` of a local config hashes only those
  blocks of the whole model's numbers (:func:`draw_plan`).
  The one leaf not placed by JAX's rule is MoE's shared expert
  (``moe/shared/*``), kept whole on every rank (:func:`placement`).
* The collectives, each the identity for a config without a mesh or on a
  model axis of 1, so every unsharded, captured or CPU path is unchanged:
  :func:`row_matmul` sums the row-parallel ``@ wo`` / ``@ down`` partial
  products over the model group in float32 and rounds once to the
  activation dtype, and :func:`row_einsum` does the same for the MoE
  combine over a rank's experts (:func:`expert_block`); :func:`embed` is
  the vocab-parallel lookup (a rank gathers its own rows, zeros the
  others, and the group sums: exactly one rank adds a non-zero row, so
  the sum is exact); :func:`vocab_offset` places a rank's vocab-sharded
  logits ``x @ table_local.T``, whose pad ids are masked by their global
  index; :func:`greedy` is the argmax over the shards, the lowest index
  on ties as ``torch.argmax``; :func:`gather_columns` assembles a
  column-parallel product's whole last dim (the vocab's logits, the
  projected patch prefix, the projected audio frames).
* The batch: :func:`batch_rows` / :func:`gather_rows` split and join the
  leading dim over the data axis as ``batch_pspecs`` says;
  :func:`gather_data` joins a MoE layer's input over the data group, so
  the routing groups and capacities are the whole batch's, as JAX forms
  them.

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
    """The config a rank of ``mesh`` runs for ``cfg`` (any arch the ten
    configs use); ValueError for a model axis that does not divide its KV
    heads and heads (where it has attention), ``d_ff``, padded vocab,
    experts or ``d_ff_dense``."""
    m = sharding.axis_sizes(mesh)["model"]
    heads = cfg.attention != "none"     # mamba2's head fields: placeholders
    if heads and cfg.n_kv_heads % m:
        raise ValueError(
            f"{cfg.name}: a model axis of {m} does not divide n_kv_heads = "
            f"{cfg.n_kv_heads}; JAX's column rule would split a head across "
            f"ranks, which a rank's local attention cannot run")
    divided = [("d_ff", cfg.d_ff), ("the padded vocab", cfg.padded_vocab)]
    if heads:
        divided.insert(0, ("n_heads", cfg.n_heads))
    if cfg.is_moe:
        divided.append(("n_experts", cfg.n_experts))
    if cfg.first_k_dense:
        divided.append(("d_ff_dense", cfg.d_ff_dense))
    for what, n in divided:
        if n % m:
            raise ValueError(f"{cfg.name}: a model axis of {m} does not "
                             f"divide {what} = {n}")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(d_ff=cfg.d_ff // m, d_ff_dense=cfg.d_ff_dense // m,
                  d_head=cfg.head_dim)
    if heads:
        fields.update(n_heads=cfg.n_heads // m,
                      n_kv_heads=cfg.n_kv_heads // m)
    return LocalConfig(**fields, mesh=mesh, full=cfg)


def _model_mesh(cfg):
    """The mesh of a local config whose model axis is above 1, else
    None."""
    mesh = getattr(cfg, "mesh", None)
    return mesh if mesh is not None and mesh.model > 1 else None


# ----------------------------------------------------------------- leaves --
def placement(path: tuple, shape: tuple, model_size: int) -> tuple:
    """The spec a rank places the parameter at ``path`` (dict keys from
    the root) by: JAX's rule, but MoE's shared expert (``moe/shared/*``)
    whole on every rank (zamba2's top-level shared attention block,
    ``shared/attn/*`` and ``shared/mlp/*``, keeps JAX's rule).  JAX's
    rule reads a stacked shared leaf ``[L, d, f]``'s layer axis as the
    expert axis, so its spec turns on whether the model axis divides the
    depth (replicated at deepseek-v2's 59 stacked layers, the layer axis
    sharded at 8), and a single layer's ``[d, f]`` gets the dense MLP's
    column / row split: XLA gathers any of them.  Whole is JAX's spec at
    full depth, and the shared expert's output then needs no sum."""
    if "moe" in path and "shared" in path:
        return (None,) * len(shape)
    return sharding._rule(tuple(path), tuple(shape), model_size)


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
    return _block(leaf, placement(path, leaf.shape, mesh.model), mesh)


def shard_params(params, mesh):
    """The rank's blocks of a whole parameter tree (copies)."""
    return sharding.map_with_path(
        lambda path, w: shard_leaf(path, w, mesh).contiguous(), params)


def draw_plan(cfg) -> tuple[ModelConfig, Optional[Callable]]:
    """(the config whose numbers an init draws; ``place(path, shape)``,
    the block (dim, first, count) of the leaf at ``path`` (dict keys from
    the root) of ``shape`` that a rank draws, or None to draw it whole;
    None for an init that draws every leaf whole).  A rank hashes only
    its blocks (``rng.normal(block=)``): the unsharded init's numbers
    there, bit for bit."""
    if not isinstance(cfg, LocalConfig):
        return cfg, None
    mesh = _model_mesh(cfg)
    if mesh is None:
        return cfg.full, None

    def place(path, shape):
        spec = placement(path, shape, mesh.model)
        dims = [d for d, entry in enumerate(spec) if entry is not None]
        if not dims:
            return None
        if len(dims) > 1 or spec[dims[0]] != "model":
            raise ValueError(f"{'/'.join(path)}: a rank draws one block "
                             f"along 'model', not {spec}")
        n = shape[dims[0]] // mesh.model
        return dims[0], mesh.model_rank * n, n

    return cfg.full, place


def scope(place, *names):
    """``place`` for the leaves under ``names``, which name them from
    there; None stays None."""
    if place is None:
        return None
    return lambda path, shape: place(names + tuple(path), shape)


def block(place, name: str, shape: tuple):
    """The block of the leaf ``name`` of ``shape`` that ``place`` gives
    (:func:`draw_plan`), or None (the whole leaf)."""
    return None if place is None else place((name,), tuple(shape))


# ------------------------------------------------------------ collectives --
def row_matmul(cfg, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a row-parallel ``w`` (``wo``, ``down``): each rank's
    partial product in float32, summed over the model group, rounded once
    to ``x``'s dtype."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return x @ w
    return mesh.model_sum(x.float() @ w.float()).to(x.dtype)


def row_einsum(cfg, eq: str, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` whose contracted dims hold a rank's share of
    the terms (the MoE combine over its experts): each rank's partial in
    float32, summed over the model group, rounded once to ``a``'s
    dtype."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return torch.einsum(eq, a, b)
    return mesh.model_sum(torch.einsum(eq, a.float(), b.float())).to(a.dtype)


def expert_block(cfg) -> tuple[int, int]:
    """(first, count) of the experts whose weights a rank holds: the
    ``model_rank``-th contiguous block of ``n_experts / model``, as the
    ``(model, None, None)`` spec places them (all of them without a model
    mesh)."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return 0, cfg.n_experts
    n = cfg.n_experts // mesh.model
    return mesh.model_rank * n, n


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


def gather_columns(cfg, t: torch.Tensor) -> torch.Tensor:
    """The whole last dim of a column-parallel ``t`` (a rank's vocab shard
    of the logits, its block of the projected patch prefix) from each
    model rank's block, on every rank of the model group: exact, no
    sum."""
    mesh = _model_mesh(cfg)
    if mesh is None:
        return t
    return torch.cat(list(mesh.model_gather(t).unbind(0)), dim=-1)


# ------------------------------------------------------------------ batch --
def batch_rows(cfg, batch, mesh):
    """The rank's rows of a batch tree as ``batch_pspecs`` places them:
    the data rank's contiguous block of a leading dim that divides over
    ``data``, every row of one that does not.  A MoE config's batch must
    divide: its layers route the data group's rows together
    (:func:`gather_data`)."""
    if mesh is None:
        return batch
    specs = sharding.batch_pspecs(cfg, batch, mesh)

    def rows(leaf, spec):
        if spec[0] is None:
            if cfg.is_moe and mesh.data > 1:
                raise ValueError(
                    f"{cfg.name}: a batch of {leaf.shape[0]} rows does not "
                    f"divide over a data axis of {mesh.data}; a MoE layer "
                    f"routes the data group's rows together, so each rank "
                    f"must hold its own block")
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


def gather_data(cfg, x: torch.Tensor) -> tuple[torch.Tensor, slice]:
    """(the data group's rows of ``x`` in data-rank order, the slice of
    them that is this rank's): a MoE layer routes the whole batch's tokens
    in JAX's groups and capacities (``x.reshape(g, tg, d)`` over ``b *
    s``), which a rank's own rows alone would not form.  Each rank holds
    its :func:`batch_rows` block; without a data axis above 1, ``x`` and
    all of it."""
    mesh = getattr(cfg, "mesh", None)
    if mesh is None or mesh.data == 1:
        return x, slice(None)
    b = x.shape[0]
    return (torch.cat(list(mesh.data_gather(x).unbind(0))),
            slice(mesh.data_rank * b, (mesh.data_rank + 1) * b))
