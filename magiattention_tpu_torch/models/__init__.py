"""Models trained with flex attention: the Llama decoder at cp=1 and under
context parallelism; ``llama_pp`` and ``dit`` are still to port (ROADMAP
queue A item 16)."""

from ._common import (
    make_model_train_step,
    masked_ce_sums,
    plan_flex_attn,
    resolve_harness_blocking,
    sum_grads_over_group,
)
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
    "plan_flex_attn",
    "resolve_harness_blocking",
    "sum_grads_over_group",
]
