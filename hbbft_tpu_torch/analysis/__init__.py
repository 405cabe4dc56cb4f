"""Protocol-invariant static analysis (the lint rule engine).

HoneyBadgerBFT's safety argument assumes every replica runs the same
deterministic state machine (Miller et al., CCS 2016; the BA subprotocol
additionally needs identical per-round behaviour across correct nodes —
Mostéfaoui–Moumen–Raynal, PODC 2014).  The reference implementation gets
much of that from Rust's type system; Python silently permits the
nondeterminism (unordered set/dict iteration on message paths, wall-clock
reads, ambient ``random``) and the unchecked-input crashes that would
violate it.  This package makes those invariants machine-checked:

* :mod:`engine`               — rule registry, findings, ``# lint:
  allow[rule-id] reason`` suppressions, checked-in baseline.
* :mod:`rules_determinism`    — no clocks/ambient randomness/unordered
  iteration in ``protocols/`` and ``core/``.
* :mod:`rules_exhaustiveness` — wire-registry message variants vs each
  protocol's ``handle_message`` dispatch.
* :mod:`rules_byzantine`      — remote input must become ``FaultLog``
  entries, never exceptions; membership checks before state writes.
* :mod:`rules_tracer`         — no host syncs inside jitted functions in
  ``engine/`` and ``ops/``; hashable static args.

Run via ``python -m hbbft_tpu_torch.tools.lint``; the tests hold every
rule's findings equal to the JAX package's copy of this engine.
"""

from hbbft_tpu_torch.analysis.engine import (
    Baseline,
    Finding,
    LintProject,
    ModuleSource,
    Rule,
    all_rules,
    run_lint,
)

__all__ = [
    "Baseline",
    "Finding",
    "LintProject",
    "ModuleSource",
    "Rule",
    "all_rules",
    "run_lint",
]
