"""Models trained with flex attention: the Llama decoder under any mix of
data, context and tensor parallelism (``llama``), the GPipe pipeline over
it (``llama_pp``), and the Magi-1-style video-diffusion transformer under
data and context parallelism (``dit``)."""

from ._common import (
    ParallelGroups,
    make_model_train_step,
    make_parallel_groups,
    masked_ce_sums,
    plan_flex_attn,
    resolve_harness_blocking,
)
from .dit import (
    DiTConfig,
    MagiDiT,
    build_magi_dit,
    chunk_causal_mask,
    dit_forward_local,
    init_dit_params,
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
    "DiTConfig",
    "LlamaConfig",
    "MagiDiT",
    "MagiLlama",
    "MagiLlamaPP",
    "ParallelGroups",
    "build_magi_dit",
    "build_magi_llama",
    "build_magi_llama_pp",
    "chunk_causal_mask",
    "dit_forward_local",
    "init_dit_params",
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
