"""The port's hot-path analyzer (counterpart of ``src/repro/analysis``,
DESIGN.md §10).

* :mod:`repro_torch.analysis.registry` — the hot modules and the hot paths
  with their sync budgets and in-place / unwritten arguments.
* :mod:`repro_torch.analysis.lint` — the AST lint (host syncs, seed
  hygiene, import-time side effects, stale registry entries).
* :mod:`repro_torch.analysis.contracts` — each hot path run twice over
  the reference's buckets: host syncs within budget (counted by a
  ``TorchFunctionMode``, and on CUDA by ``set_sync_debug_mode``), state
  written in place, shared inputs unwritten, no 64-bit widening.
"""
from . import registry  # noqa: F401
