"""Optimizers over the port's parameter trees (PyTorch port of
``repro.optim``)."""
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm,
                                          cosine_warmup_schedule,
                                          global_norm, sgd)

__all__ = ["Optimizer", "adamw", "sgd", "clip_by_global_norm",
           "global_norm", "apply_updates", "cosine_warmup_schedule"]
