"""Warehouse correctness toolkit: invariant lint, lockdep, plan validator,
schema-flow checker.

Four analyzers, one entry point (``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.lint` — AST lint over the warehouse sources
  enforcing repo-specific invariants REP001..REP006 (declared config keys,
  cancellable reader loops, no new full-materialization sites, lock/
  condition hygiene, validated live-DAG mutation, schema-derived operator
  output columns);
* :mod:`repro_torch.analysis.lockdep` — runtime lock-order sanitizer behind the
  ``REPRO_LOCKDEP`` env var; lock factories used across the runtime;
* :mod:`repro_torch.analysis.plan_validator` — structural checks on every
  compiled task DAG behind ``debug.validate_plans`` /
  ``REPRO_VALIDATE_PLANS``;
* :mod:`repro_torch.analysis.schema_check` — static schema-flow verification
  (rules SCH001..SCH006) over the typed contract ``repro_torch.core.schema``
  attaches to plans and DAGs, run by ``check_dag`` after the structural
  pass (the runtime counterpart — per-morsel exchange conformance — sits
  behind ``REPRO_CHECK_BATCHES`` / ``debug.check_batches``).
"""
from .lint import CODES, Finding, lint_file, lint_paths, lint_source
from .lockdep import (LockOrderError, TrackedCondition, TrackedLock,
                      TrackedRLock, make_condition, make_lock, make_rlock)
from .plan_validator import (PlanValidationError, check_dag,
                             maybe_validate_dag, validate_dag)
from .schema_check import RULES, validate_dag_schemas, validate_plan_schema

__all__ = [
    "CODES", "Finding", "lint_file", "lint_paths", "lint_source",
    "LockOrderError", "TrackedCondition", "TrackedLock", "TrackedRLock",
    "make_condition", "make_lock", "make_rlock",
    "PlanValidationError", "check_dag", "maybe_validate_dag", "validate_dag",
    "RULES", "validate_dag_schemas", "validate_plan_schema",
]
