"""Static and recorded analysis of the port: the machine-checked invariants
the architecture rests on. The JAX package's ``analysis/``, aimed at
PyTorch.

Five passes, one CLI (``python -m magiattention_tpu_torch.analysis``):

- :mod:`.lint` — AST idiom linter over the package source (MAGI002,
  MAGI003, MAGI005; JSON allowlist + inline pragma).
- :mod:`.trace_audit` — the collective census of every cast against its
  comm meta, recorded dry for every rank (the comm layer's recorder in
  place of a jaxpr), the guard and upcast census under torch's dispatch
  modes, and the rebuild guard (a same-shape call with new values builds
  nothing).
- :mod:`.plan_sanity` — structural sanitizer for AttnSlices /
  DistAttnPlan / GroupCollectiveMeta, run at plan-build time behind
  ``MAGI_ATTENTION_VALIDATE=off|plan|trace``.
- :mod:`.spmd_audit` — SPMD collective consistency: every rank's recorded
  collective signature must be identical (a divergence hangs), with hop
  pairing well-formed on every exchange.
- :mod:`.lifecycle` — serving-state interleaving checker: an explicit-state
  model checker driving the real host serving objects over a stubbed
  device layer through bounded event interleavings.

Everything here is host-side tooling: importing this package builds and
launches nothing.
"""

from .lint import (  # noqa: F401
    RULES,
    Violation,
    lint_package,
    lint_paths,
    lint_source,
    load_allowlist,
)
from .plan_sanity import (  # noqa: F401
    PlanValidationError,
    validate_comm_meta,
    validate_plan,
    validate_slices,
)
from .trace_audit import (  # noqa: F401
    AuditFailure,
    collective_census,
    count_traces,
    expected_cast_collectives,
    upcast_census,
)
