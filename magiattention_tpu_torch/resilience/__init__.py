"""Resilience: so far only the fault-injection spec's grammar
(:mod:`.chaos`), which ``env.chaos_spec`` validates a
``MAGI_ATTENTION_CHAOS`` value with. The injectors and the numerical guards
are not ported yet, so the port refuses any chaos spec and any guard mode
(``env.refuse_unhonoured_flags``)."""

from .chaos import ChaosClause, parse_chaos_spec  # noqa: F401
