"""repro_torch.analysis: static-analysis and sanitizer tooling of the port's
serving engine, ported from ``repro.analysis``.

Three parts, one CLI (``python -m repro_torch.analysis``):

* ``step_audit`` — declarative ``StepContract``s checked against one call of
  each of the engine's step programs under instruments: a collective census
  (``c10d`` ops), a host-sync scan (syncing ops, and on CUDA
  ``set_sync_debug_mode("error")``), the int8 dtype flow (no whole-pool
  upcast; the int8 pools reach the paged kernels) and a cache sentinel
  against ``warmup_step_variants()``'s packed lengths.
* ``lint`` — AST lint with repo-specific rules over ``src/repro_torch``
  (host/device layering, the block-table ``pad=-1`` contract, scheduling
  determinism, one generator draw per dispatch).
* ``kvsan`` — a shadow-state sanitizer for the three-tier KV block
  lifecycle, enabled by ``PagedKVCache(sanitize=True)`` /
  ``GenerationEngine(sanitize=True)``.

Every rule is mutation-tested: ``python -m repro_torch.analysis <cmd>
--mutate <id>`` seeds one deliberate violation and must exit nonzero; the
clean tree exits zero.
"""
from repro_torch.analysis.kvsan import KVSanError, KVSanitizer
from repro_torch.analysis.lint import LintViolation, run_lint
from repro_torch.analysis.step_audit import AuditReport, Finding, StepContract, audit_engine

__all__ = [
    "AuditReport",
    "Finding",
    "KVSanError",
    "KVSanitizer",
    "LintViolation",
    "StepContract",
    "audit_engine",
    "run_lint",
]
