"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version in the same module: :mod:`.store_probe` (the keyed-state
probe behind ``DeviceStateStore``), :mod:`.feed_fused` (the fused
keyed-stream segment), :mod:`.fish_count` (the device FISH tracker's
match-count) and :mod:`.ssd` (the Mamba-2 chunked scan).  Sources live in ``repro_torch/csrc/``; they build
with ``nvcc`` at first use (:mod:`._build`), never at import."""
