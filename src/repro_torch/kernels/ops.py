"""Public entry points of the port's kernels.

``store_probe`` dispatches on the tensors' device: the CUDA kernel on a
card, its plain PyTorch version on the CPU (see
:mod:`repro_torch.kernels.store_probe`).  The ``fish_count`` and SSD
kernels of the JAX package are not ported yet.
"""

from __future__ import annotations

from .store_probe import store_probe

__all__ = ["store_probe"]
