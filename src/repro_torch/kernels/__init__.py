"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version in the same module: :mod:`.store_probe` (the keyed-state
probe behind ``DeviceStateStore``) and :mod:`.feed_fused` (the fused
keyed-stream segment).  Sources live in ``repro_torch/csrc/``; they build
with ``nvcc`` at first use (:mod:`._build`), never at import."""
