"""Utilities of the port: instrumentation, cost factors, sample packing,
checkpointing and plan pictures (the JAX package's ``utils/`` but its
``compat.py``, whose shims have no torch role)."""

from .checkpoint import latest_step, restore_train_state, save_train_state
from .cost import CARD_PEAK_SPECS, get_calc_cost_factor, get_comm_cost_factor
from .instrument import (
    add_trace_event,
    instrument_trace,
    instrumentation_active,
    named_scope,
    switch_profile,
    trace_session_active,
)
from .packing import bin_cu_seqlens, pack_corpus, pack_documents, packing_efficiency
from .vis import plot_dynamic_solution, plot_mask

__all__ = [
    "CARD_PEAK_SPECS",
    "add_trace_event",
    "bin_cu_seqlens",
    "get_calc_cost_factor",
    "get_comm_cost_factor",
    "instrument_trace",
    "instrumentation_active",
    "latest_step",
    "named_scope",
    "pack_corpus",
    "pack_documents",
    "packing_efficiency",
    "plot_dynamic_solution",
    "plot_mask",
    "restore_train_state",
    "save_train_state",
    "switch_profile",
    "trace_session_active",
]
