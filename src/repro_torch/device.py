"""Device rule of the port: the card by default, the CPU only on request."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means ``cuda``; this raises when CUDA is absent instead of
    continuing on the CPU. ``"cpu"`` is accepted only because the caller
    asked for it (the CPU parity tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
