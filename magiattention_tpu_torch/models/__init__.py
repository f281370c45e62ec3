"""Models trained with flex attention. This slice has the single-device
Llama decoder; ``llama_pp`` and ``dit`` are still to port (ROADMAP queue A
item 16)."""

from ._common import make_model_train_step, masked_ce_sums, resolve_harness_blocking
from .llama import (
    LlamaConfig,
    MagiLlama,
    build_magi_llama,
    init_params,
)

__all__ = [
    "LlamaConfig",
    "MagiLlama",
    "build_magi_llama",
    "init_params",
    "make_model_train_step",
    "masked_ce_sums",
    "resolve_harness_blocking",
]
