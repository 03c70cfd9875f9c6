"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel package holds ``ref.py`` (the plain version, which the CPU
tests run and ``chip_smoke.py`` holds the kernel against) and ``ops.py``
(the wrapper: checks its inputs, uses the plain version for tensors on the
CPU, and launches the kernel for tensors on the card, counting launches).
The sources are under ``repro_torch/csrc`` and :mod:`.build` compiles them.
"""
