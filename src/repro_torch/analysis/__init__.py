"""Correctness-analysis tooling for the NVMM engine.

Three cooperating checkers (see README.md in this directory):

* :mod:`repro.analysis.pmcheck`   — persistence-ordering sanitizer
  (pmemcheck-style shadow map over the NVMM commit protocols).
* :mod:`repro.analysis.lockcheck` — runtime lock-order recorder against
  the hierarchy in :mod:`repro.core.locking`.
* :mod:`repro.analysis.lint`      — AST static pass over ``repro.core``
  (``python -m repro.analysis.lint``).

:mod:`repro.analysis.sanitize` wires the two runtime checkers into a live
process (``pytest --sanitize`` uses it from ``tests/conftest.py``).
"""
