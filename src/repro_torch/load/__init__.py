"""Open-loop load subsystem: arrival processes, admission
control + backpressure, an open-loop session driver, and p99-driven
autoscaling.  See DESIGN.md §13 for the semantics and
``benchmarks/bench_slo.py`` for the headline max-sustainable-load sweep.
"""

from .admission import POLICIES, AdmissionStats, IngressQueue
from .arrivals import (ArrivalProcess, ConstantRate, DiurnalRate,
                       FlashCrowd, FlipZipfKeys, MarkovModulatedRate,
                       RateFn, ZipfKeys)
from .autoscale import P99Autoscaler
from .driver import LoadReport, OpenLoopDriver

__all__ = [
    "POLICIES",
    "AdmissionStats",
    "IngressQueue",
    "ArrivalProcess",
    "ConstantRate",
    "DiurnalRate",
    "FlashCrowd",
    "FlipZipfKeys",
    "MarkovModulatedRate",
    "RateFn",
    "ZipfKeys",
    "P99Autoscaler",
    "LoadReport",
    "OpenLoopDriver",
]
