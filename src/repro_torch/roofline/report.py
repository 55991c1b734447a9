"""Model accounting (PyTorch port of the accounting half of
``repro.roofline.report``): parameters without the embedding, total and
activated, and the model FLOPs of a step (6ND for training, 2ND for
inference).

The counts come from the shapes of ``api.init_params`` on a ``meta`` key
(:mod:`repro_torch.rng` draws nothing there), so no weight is drawn or
stored.  The JAX module's other half, which reads XLA's cost analysis of
compiled TPU dry runs and prices it in TPU v5e constants, has no
counterpart here (ROADMAP.md, "Not ported").
"""
from __future__ import annotations

import functools

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.tree import tree_leaves_with_path


@functools.lru_cache(maxsize=None)
def _param_counts(arch_id: str) -> tuple[int, int]:
    """(total_params, activated_params) excluding the embedding table; an
    MoE expert weight counts top_k / n_experts of itself as activated."""
    cfg = get_config(arch_id)
    shapes = api.init_params(rng.PRNGKey(0, device="meta"), cfg)
    total = active = 0
    for path, leaf in tree_leaves_with_path(shapes):
        names = [str(p) for p in path]
        n = leaf.numel()
        if "embed" in names:        # 6ND convention: matmul params only
            continue
        total += n
        if "moe" in names and names[-1] in ("gate", "up", "down"):
            active += n * cfg.moe_top_k // max(cfg.n_experts, 1)
        else:
            active += n
    return total, active


def model_flops(arch_id: str, shape: dict, kind: str) -> float:
    """Global 6ND (``kind`` "train") or 2ND (prefill: every position;
    decode: one new token a sequence), N the activated parameters."""
    _, active = _param_counts(arch_id)
    if kind == "train":
        return 6.0 * active * shape["global_batch"] * shape["seq_len"]
    if kind == "prefill":
        return 2.0 * active * shape["global_batch"] * shape["seq_len"]
    return 2.0 * active * shape["global_batch"]
