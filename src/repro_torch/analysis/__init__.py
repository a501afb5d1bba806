"""``repro_torch.analysis`` — the port's runtime sanitizer.

Counterpart of ``repro/analysis``'s runtime half,
:func:`repro_torch.analysis.sanitize.sanitized`: a block run with hidden
host syncs refused, NaNs raised at the op that made them, and a hard
compile budget.  The static half (``python -m repro.analysis --strict src
benchmarks``) has no copy here: it is stdlib-only, reads source text, and
already gates the port's files.
"""
from __future__ import annotations

from .sanitize import CompileBudgetExceeded, allowed_sync, compiles_now, sanitized

__all__ = ["CompileBudgetExceeded", "allowed_sync", "compiles_now", "sanitized"]
