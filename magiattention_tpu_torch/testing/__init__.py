"""Testing library: the fp64 dense oracle and the reference mask workloads
(``testing.workloads``)."""

from .ref_attn import ref_attn, ref_attn_from_ranges

__all__ = ["ref_attn", "ref_attn_from_ranges"]
