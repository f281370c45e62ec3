"""Models trained with flex attention: the Llama decoder under any mix of
data, context and tensor parallelism (``llama``) and the GPipe pipeline
over it (``llama_pp``); ``dit`` is still to port (ROADMAP queue A item
16)."""

from ._common import (
    ParallelGroups,
    make_model_train_step,
    make_parallel_groups,
    masked_ce_sums,
    plan_flex_attn,
    resolve_harness_blocking,
)
from .llama import (
    LlamaConfig,
    MagiLlama,
    build_magi_llama,
    init_params,
    shard_llama_params,
)
from .llama_pp import (
    MagiLlamaPP,
    build_magi_llama_pp,
    init_pp_params,
    stack_layer_params,
)

__all__ = [
    "LlamaConfig",
    "MagiLlama",
    "MagiLlamaPP",
    "ParallelGroups",
    "build_magi_llama",
    "build_magi_llama_pp",
    "init_params",
    "init_pp_params",
    "make_model_train_step",
    "make_parallel_groups",
    "masked_ce_sums",
    "plan_flex_attn",
    "resolve_harness_blocking",
    "shard_llama_params",
    "stack_layer_params",
]
