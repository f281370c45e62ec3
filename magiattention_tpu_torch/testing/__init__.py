"""Testing library: the fp64 dense oracle, the reference mask workloads
(``testing.workloads``) and the rank spawner of multi-rank runs
(``testing.dist``)."""

from .ref_attn import ref_attn, ref_attn_from_ranges

__all__ = ["ref_attn", "ref_attn_from_ranges"]
