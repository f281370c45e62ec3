"""The cp spec of the port's entry points, normalised in one place.

The JAX package names its cp axis by one mesh-axis name, or by an ``(inter,
intra)`` pair for hierarchical two-level comm (its ``common/axes.py``). The
port's spec is a ``torch.distributed`` process group of the cp ranks, or a
``comm.HierCpGroups`` (``comm.make_hier_cp_groups``) for the two-level
layout. Every layer that takes a cp spec (the keyed API, the distributed
runtime, the trainer) asks here whether it is hierarchical, which group
spans all its ranks and what its layout is, so the flat-vs-hierarchical
decision lives in one place.
"""

from __future__ import annotations


def _is_hier(cp_group) -> bool:
    from ..comm.hier import HierCpGroups  # comm imports common: resolve at call time

    return isinstance(cp_group, HierCpGroups)


def cp_axis_names(cp_group) -> tuple:
    """The groups of each level of a cp spec: ``(group,)`` for a flat
    group, this rank's ``(inter, intra)`` subgroups for a
    ``HierCpGroups`` (two levels = hierarchical, as two axis names are in
    the JAX package)."""
    if _is_hier(cp_group):
        return (cp_group.inter, cp_group.intra)
    return (cp_group,)


def split_cp_group(cp_group):
    """(the group over every cp rank, the ``(n_inter, n_intra)`` layout or
    None for a flat spec)."""
    if _is_hier(cp_group):
        return cp_group.flat, cp_group.shape
    return cp_group, None


def cp_axis_size(cp_group) -> int:
    """The cp world size over every level of the spec."""
    import torch.distributed as dist

    flat, shape = split_cp_group(cp_group)
    return shape[0] * shape[1] if shape is not None else dist.get_world_size(flat)
