"""Uniform model API (PyTorch port of ``repro.models.api``): the serving
entry points of the decoder-only models.  The encoder-decoder dispatch of
the JAX module is not ported yet (ROADMAP.md A.1d; ``lm`` raises for such a
config), nor the training side (A.1f).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

PyTree = Any


def init_params(key: torch.Tensor, cfg: ModelConfig) -> PyTree:
    return lm.init_params(key, cfg)


def prefill_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    return lm.prefill(params, cfg, batch)


def init_cache(cfg: ModelConfig, b: int, s: int, device=None) -> PyTree:
    return lm.init_cache(cfg, b, s, device=device)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    return lm.decode_step(params, cfg, cache, token, pos)
