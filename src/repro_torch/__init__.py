"""PyTorch + CUDA port of the mobility-aware FL system (``repro``).

A second package beside the JAX reference with the same module layout:
``repro_torch.core.channel`` is the counterpart of ``repro.core.channel``,
and so on.  It imports torch and numpy only.  The hand-written Hopper
kernels of its hot path live in ``csrc/`` and build on first use
(:mod:`repro_torch.kernels._lib`).
"""
