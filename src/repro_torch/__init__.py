"""PyTorch + CUDA port of the mobility-aware FL system (``repro``).

A second package beside the JAX reference with the same module layout:
``repro_torch.core.channel`` is the counterpart of ``repro.core.channel``,
and so on.  It imports torch and numpy only.  The hand-written Hopper
kernels of its hot path live in ``csrc/`` and build on first use
(:mod:`repro_torch.kernels._lib`).
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is absent and no
    device was given.  Every entry point of the port resolves its device
    here, so none falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


def const(value, dtype=torch.float32, device=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``.  A Python or
    numpy number is made by a fill on its device rather than a copy from
    the host, so a CUDA graph can hold it (the same value, rounded to
    ``dtype`` once); a tensor, a list or an array goes through
    ``torch.as_tensor``."""
    if (isinstance(value, (torch.Tensor, list, tuple))
            or getattr(value, "ndim", 0)):
        return torch.as_tensor(value, dtype=dtype, device=device)
    return torch.full((), value.item() if hasattr(value, "item") else value,
                      dtype=dtype, device=device)
