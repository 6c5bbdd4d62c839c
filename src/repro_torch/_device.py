"""Device resolution shared by every device entry point of the port.

The fused runner, the device state store and every kernel wrapper run on
``cuda`` unless the caller passes ``device="cpu"`` (as the CPU tests do).
With no card and no explicit CPU device they raise: nothing on the device
path silently carries on on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port's device path runs on "
            "the card; pass device='cpu' to run the kernels' plain "
            "PyTorch versions on the host")
    return dev
