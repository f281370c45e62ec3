"""Drop-in attention extensions: sink-augmented standard attention
(``flash_attention_with_sink``) and DSA-style top-k block-sparse attention
(``dsa_attn_func`` with its indexer ``dsa_topk_blocks``)."""

from .dsa import dsa_attn_func, dsa_topk_blocks
from .sink_attention import flash_attention_with_sink

__all__ = [
    "dsa_attn_func",
    "dsa_topk_blocks",
    "flash_attention_with_sink",
]
