"""PyTorch + CUDA port of the FISH stream-grouping reproduction.

Same module layout as the JAX package it is held against: ``core``
(groupers, FIFO simulator), ``data`` (stream generators), ``state`` (keyed
window state and its stores), ``kernels`` (hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version), ``topology`` (sessions and
reports) and ``obs`` (telemetry).  Device entry points run on ``cuda``
unless given ``device="cpu"``.
"""
