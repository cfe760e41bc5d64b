"""Correctness tooling for the port's serving stack (DESIGN.md §12).

The port of ``repro.analysis``; it imports neither ``jax`` nor
``repro``.  Three passes keep the serving stack's invariants
machine-checked instead of enforced-by-example:

* :mod:`repro_torch.analysis.invariants` — runtime validators for the
  documented §5/§6/§9 structural rules (per-shard slot uniqueness,
  frozen ``group_copies``/tile space, residency↔tier consistency,
  evict/fetch disjointness, packed-key capacity).  Opt-in via the
  ``RECROSS_VALIDATE=1`` environment variable; wired into plan build,
  patch apply-barriers and drain quiescence (default-on in the test
  suite through ``conftest.py``).
* :mod:`repro_torch.analysis.races` — a static AST pass over
  ``repro_torch/serve`` that extracts which locks guard which
  ``self._*`` attributes, reports attributes touched both inside and
  outside their dominant lock and any lock-acquisition-order violation
  against the blessed order (DESIGN.md §5), plus
  :class:`~repro_torch.analysis.races.LockMonitor` — a runtime wrapper
  recording *real* acquisition orders under threaded traffic to
  cross-check the static graph.
* :mod:`repro_torch.analysis.lint` — repo-specific AST lint rules
  (packed-key arithmetic must route through guard helpers, no
  unseeded randomness — torch's global generator included — no
  unreferenced ``_reference_*`` oracle, no wall-clock reads in
  deterministic merge/ordering paths, ``PlanPatch`` mutated only via
  ``apply_plan_patch``, public ``serve``/``dist`` docstring coverage).

CLI gate: ``python -m repro_torch.analysis --strict`` runs the lint and
the static lock pass and exits nonzero on any finding.
"""

from repro_torch.analysis.invariants import (
    InvariantViolation,
    validate_patch,
    validate_plan,
    validate_server_state,
    validation_enabled,
)
from repro_torch.analysis.lint import Finding, run_lint
from repro_torch.analysis.races import (
    LockMonitor,
    LockOrderError,
    analyze_locks,
    monitor_server,
)

__all__ = [
    "InvariantViolation",
    "validate_plan",
    "validate_patch",
    "validate_server_state",
    "validation_enabled",
    "Finding",
    "run_lint",
    "analyze_locks",
    "LockMonitor",
    "LockOrderError",
    "monitor_server",
]
