"""Checkpointing: parameter tree <-> .npz with structure metadata (PyTorch
port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree"]
