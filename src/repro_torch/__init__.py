"""FeatureBox on PyTorch and CUDA (NVIDIA Hopper).

The module layout mirrors the JAX package ``repro`` so every module's
counterpart is easy to find; this package imports neither JAX nor ``repro``
and keeps its own copies of the framework-free modules it needs.

Entry points run on the card unless the caller asks for the CPU
(:func:`repro_torch.device.resolve_device`). Hand-written CUDA kernels live
in ``csrc/`` and are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`); each wrapper falls back to its plain
PyTorch version only for tensors that lie on the CPU.
"""
