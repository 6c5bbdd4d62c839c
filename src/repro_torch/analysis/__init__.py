"""The main path's contract, checkable at run time (DESIGN.md §11, §15).

- :mod:`.contracts` — the scheme × engine exactness table, the DESIGN.md
  §6 bands, the launch/sync budgets of a fused edge and the static
  mirrors of the runtime topology/config build errors;
- :mod:`.audit` — :class:`~.audit.EdgeAuditor`, the launch and sync
  auditor of a live fused runner, and :class:`~.audit.LaunchBudget`;
- :mod:`.sanitize` — the same-seed double run under strict numerics
  (numpy faults raise, the fused runner's readbacks must be finite),
  reports diffed bit for bit.

The reference's static lint (AST rules, call graph, CLI) is not part of
the port: the repo's lint gate scans this package with it.
"""

from .contracts import (BANDED_SCHEMES, BANDS, DRIFT_SCHEMES, EXACT_SCHEMES,
                        EXACTNESS, F32_REL, SCALE_TARGET, SCHEMES,
                        SEGMENT_KERNELS, exactness, row_violations)

__all__ = [
    "SCHEMES", "EXACTNESS", "EXACT_SCHEMES", "BANDED_SCHEMES",
    "DRIFT_SCHEMES", "exactness", "SCALE_TARGET", "SEGMENT_KERNELS",
    "F32_REL", "BANDS", "row_violations",
]
