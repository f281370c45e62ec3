"""Hierarchical (two-level) GroupCast over (inter, intra) process subgroups.

The port's counterpart of the JAX package's ``comm/hier.py``: when several
ranks of one node need the same K/V row of a remote node, it crosses the
slow inter-node link once, to a gateway rank, and the gateway fans it out
within the node over the fast links. The cp ranks form an (n_inter,
n_intra) grid: cp rank r is node ``r // n_intra``, intra position
``r % n_intra`` (:class:`HierCpGroups`).

Routing: src rank s = (Sn, si) sends the union of the rows any rank of
node Dn needs to the gateway g = (Dn, si) (its own intra position, over
the inter subgroup); the gateway forwards each row to its consumers over
the intra subgroup. The final receive layout at rank d = (Dn, di) is
(gateway si asc, src node Sn asc, gateway-buffer position), returned by
:meth:`HierGroupCollectiveMeta.build` as ``recv_sources``. The host side
is a copy of the JAX package's and gives byte-identical routing arrays.

On the device each level is a flat group collective of its own
(:attr:`HierGroupCollectiveMeta.inter_level` / ``intra_level``, one
:class:`~.group_collective.RankRouting` per level): the inter level is one
``all_to_all_single`` over the inter subgroup (world n_inter, rank =
node); the intra level takes the gateway buffer and runs the resolved
impl (a2a, or hop scheduling on the intra level only) over the intra
subgroup (world n_intra, rank = intra). :func:`group_reduce_hier` is the
cast's transpose: the intra reduce sums the partials at the gateway (the
pre-reduce), then the inter reduce returns each unique row once. JAX
transposes the cast; here each level's reduce needs (position, owner row)
pairs, taken from that level's pair counts: a pad slot repeats row 0 and
is never summed onto it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from .group_collective import (
    GroupCollectiveMeta,
    HopPlan,
    RankRouting,
    _hop_padded_sizes,
    _resolve_impl,
    cast_transpose,
    group_cast,
    rank_routing,
)


@dataclasses.dataclass(frozen=True, eq=False)
class HierCpGroups:
    """The cp ranks as an (n_inter, n_intra) grid of ``torch.distributed``
    groups: ``flat`` spans every cp rank (dispatch, undispatch, the loss
    count, the gradient sum and the max-logit all-reduce run over it),
    ``inter`` is this rank's inter-node subgroup (the ranks of its intra
    position, one per node, in node order) and ``intra`` its node's
    subgroup. Passing it as ``cp_group`` selects the hierarchical plan, the
    counterpart of the JAX package's ``cp_axis=(inter, intra)`` pair."""

    flat: object
    inter: object
    intra: object
    n_inter: int
    n_intra: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_inter, self.n_intra)


def make_hier_cp_groups(cp_group, n_inter: int, n_intra: int) -> HierCpGroups:
    """The subgroups of an (n_inter, n_intra) layout of ``cp_group``'s
    ranks: cp rank r is node ``r // n_intra``, intra ``r % n_intra``.

    Every rank of the default group calls ``dist.new_group`` for all
    n_intra inter groups, then all n_inter intra groups, in that fixed
    order, as ``new_group`` requires; so every rank of the default group
    calls this, with the same arguments, and ``cp_group`` must span the
    default group. Make it once and pass the holder to every key and
    model of that layout."""
    n_inter, n_intra = int(n_inter), int(n_intra)
    cp = dist.get_world_size(cp_group)
    if n_inter < 1 or n_intra < 1 or n_inter * n_intra != cp:
        raise ValueError(f"a ({n_inter}, {n_intra}) layout does not cover the group's "
                         f"{cp} ranks")
    if cp != dist.get_world_size():
        raise ValueError(f"make_hier_cp_groups needs a cp group that spans the default group "
                         f"({cp} of {dist.get_world_size()} ranks): every rank of the "
                         "default group creates the subgroups")
    ranks = [dist.get_global_rank(cp_group, r) for r in range(cp)]
    me = dist.get_rank(cp_group)
    node, intra = divmod(me, n_intra)
    inter_groups = [dist.new_group([ranks[n * n_intra + i] for n in range(n_inter)])
                    for i in range(n_intra)]
    intra_groups = [dist.new_group([ranks[n * n_intra + i] for i in range(n_intra)])
                    for n in range(n_inter)]
    return HierCpGroups(cp_group, inter_groups[intra], intra_groups[node], n_inter, n_intra)


@dataclasses.dataclass(frozen=True, eq=False)
class HierGroupCollectiveMeta:
    """Two-hop routing plan. Rank index = inter * n_intra + intra.

    The fields up to ``intra_local_rows`` are the JAX package's, byte for
    byte. ``inter_level`` and ``intra_level`` are the two levels as flat
    :class:`GroupCollectiveMeta`s (leading axis: all n ranks; ``cp_size``:
    the level's world), with the owner rows of the reduce (``seg_ids``)
    from the level's pair counts; the intra level's input rows are the
    gateway buffer's R1 rows."""

    n_inter: int
    n_intra: int
    # hop 1: over the inter subgroup; per-rank routing rows, world = n_inter
    inter_send_idx: np.ndarray  # [n, n_inter, S1]
    inter_recv_sel: np.ndarray  # [n, R1]
    inter_recv_valid: np.ndarray  # [n, R1]
    # hop 2: over the intra subgroup; world = n_intra; sends rows of the
    # gateway buffer (hop-1 output)
    intra_send_idx: np.ndarray  # [n, n_intra, S2]
    intra_recv_sel: np.ndarray  # [n, R2]
    intra_recv_valid: np.ndarray  # [n, R2]
    recv_total: tuple[int, ...]  # valid final rows per rank
    inter_rows_total: tuple[int, ...]  # hop-1 payload rows per rank (dedup'd)
    send_total: tuple[int, ...] = ()  # = inter_rows_total (diagnostics)
    # intra-level hop schedule (leading axis = all n ranks; the hop world
    # is the intra subgroup) — built when impl == 'hops'
    pad_to: int = 8
    impl: str = "a2a"
    impl_reason: str = "legacy"
    intra_hops: tuple[HopPlan, ...] = ()
    intra_true_rows: int = 0  # real final-fan-out rows across the group
    intra_local_rows: int = 0  # gateway-keeps-own rows, never on wire
    # the two levels as flat group collectives (the port's device side)
    inter_level: GroupCollectiveMeta | None = None
    intra_level: GroupCollectiveMeta | None = None

    @property
    def max_recv(self) -> int:
        return int(self.intra_recv_sel.shape[1])

    @property
    def padded_rows_per_rank(self) -> int:
        """Payload rows per rank with both levels padded to their global
        maxima."""
        return int(
            self.n_inter * self.inter_send_idx.shape[2]
            + self.n_intra * self.intra_send_idx.shape[2]
        )

    @property
    def scheduled_rows_per_rank(self) -> int:
        """Rows per rank the selected impls schedule: the inter a2a's
        padded buffer plus — per impl — the intra a2a's padded buffer or
        the sum of wire-crossing intra hop sizes."""
        inter = self.n_inter * int(self.inter_send_idx.shape[2])
        if self.impl == "hops":
            intra = sum(
                h.size for h in self.intra_hops
                if h.shift % self.n_intra != 0
            )
        else:
            intra = self.n_intra * int(self.intra_send_idx.shape[2])
        return inter + intra

    @property
    def true_rows_total(self) -> int:
        """Real routed rows across the group, both levels (dedup'd inter
        unions + final intra fan-out)."""
        return sum(self.inter_rows_total) + self.intra_true_rows

    @property
    def scheduled_rows_total(self) -> int:
        return self.n_inter * self.n_intra * self.scheduled_rows_per_rank

    @property
    def padding_overhead_ratio(self) -> float:
        """Scheduled rows / true rows on the scheduled pairs (hop-
        scheduled intra levels move gateway-keeps-own rows by local
        copy, so those leave the base)."""
        t = self.true_rows_total
        if self.impl == "hops":
            t -= self.intra_local_rows
        return (self.scheduled_rows_total / t) if t else 0.0

    @staticmethod
    def inter_crossing_rows(
        send_map, n_inter: int, n_intra: int
    ) -> int:
        """Total hop-1 union rows that physically cross the inter link
        (destination node != source node) — the quantity the overlap cost
        model prices at the inter-node rate. Same-node hop-1 slots are
        local copies and excluded. Cheap: only the hop-1 unions are
        formed."""
        n = n_inter * n_intra
        total = 0
        for s in range(n):
            sn = s // n_intra
            for dn in range(n_inter):
                if dn == sn:
                    continue
                rows = np.unique(
                    np.concatenate(
                        [
                            np.asarray(send_map[s][dn * n_intra + di])
                            for di in range(n_intra)
                        ]
                        + [np.empty(0, np.int64)]
                    )
                )
                total += len(rows)
        return total

    @staticmethod
    def build(
        send_map: list[list[np.ndarray]],  # [src rank][dst rank] local rows
        num_local_rows: list[int],
        n_inter: int,
        n_intra: int,
        pad_to: int | None = None,
        impl: str | None = None,
    ) -> tuple["HierGroupCollectiveMeta", list[list[tuple[int, np.ndarray]]]]:
        """Build the two-hop plan.

        Returns (meta, recv_sources) where ``recv_sources[d]`` lists
        (src_rank, src_local_rows) in the FINAL receive order at rank d —
        what the planner needs to lay out runs (global ids =
        pos_ids[src][rows]).

        ``pad_to`` / ``impl`` default to the env flags
        (``MAGI_ATTENTION_COMM_PAD_TO`` / ``_GROUP_COLL_IMPL``); 'auto'
        resolves by the INTRA level's predicted wire volume — hop
        scheduling composes on the inner (fast-link) level only, the
        inter a2a always stays one fused collective per inter crossing.
        """
        from .. import env

        if pad_to is None:
            pad_to = env.comm_pad_to()
        if impl is None:
            impl = env.group_coll_impl()
        n = n_inter * n_intra
        assert len(send_map) == n

        def rank(node, intra):
            return node * n_intra + intra

        for s in range(n):
            for d in range(n):
                rows = send_map[s][d]
                assert len(rows) == 0 or (
                    np.asarray(rows) < num_local_rows[s]
                ).all(), f"send_map[{s}][{d}] rows exceed local count"

        # hop 1: union rows per (src rank, dst node), sorted by src-local idx
        s1 = [[np.empty(0, np.int64) for _ in range(n_inter)] for _ in range(n)]
        for s in range(n):
            for dn in range(n_inter):
                rows = np.unique(
                    np.concatenate(
                        [send_map[s][rank(dn, di)] for di in range(n_intra)]
                        + [np.empty(0, np.int64)]
                    )
                )
                s1[s][dn] = rows.astype(np.int64)

        S1 = max(1, max(len(s1[s][dn]) for s in range(n) for dn in range(n_inter)))
        S1 = -(-S1 // pad_to) * pad_to
        # gateway buffer at g=(Dn, si): concat over Sn of s1[(Sn, si)][Dn]
        gw_rows: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n)]
        gw_len = [0] * n
        gw_offsets: dict[tuple[int, int], int] = {}  # (gateway, src rank) -> base
        for dn in range(n_inter):
            for si in range(n_intra):
                g = rank(dn, si)
                pos = 0
                for sn in range(n_inter):
                    s = rank(sn, si)
                    rows = s1[s][dn]
                    gw_offsets[(g, s)] = pos
                    gw_rows[g].append((s, rows))
                    pos += len(rows)
                gw_len[g] = pos

        inter_send = np.zeros((n, n_inter, S1), np.int32)
        R1 = max(1, max(gw_len))
        R1 = -(-R1 // pad_to) * pad_to
        inter_sel = np.full((n, R1), n_inter * S1, np.int32)
        inter_valid = np.zeros((n, R1), bool)
        for s in range(n):
            for dn in range(n_inter):
                rows = s1[s][dn]
                inter_send[s, dn, : len(rows)] = rows
        for g in range(n):
            pos = 0
            for sn in range(n_inter):
                s = rank(sn, g % n_intra)
                rows = s1[s][g // n_intra]
                inter_sel[g, pos : pos + len(rows)] = sn * S1 + np.arange(
                    len(rows)
                )
                inter_valid[g, pos : pos + len(rows)] = True
                pos += len(rows)

        # hop 2: gateway g=(Dn, si) -> local dst (Dn, di): the gateway-buffer
        # positions of the rows dst needs from each src (Sn, si)
        s2 = [[np.empty(0, np.int64) for _ in range(n_intra)] for _ in range(n)]
        for dn in range(n_inter):
            for di in range(n_intra):
                d = rank(dn, di)
                for si in range(n_intra):
                    g = rank(dn, si)
                    idx_parts = []
                    for sn in range(n_inter):
                        s = rank(sn, si)
                        need = send_map[s][d]
                        if len(need) == 0:
                            continue
                        union = s1[s][dn]
                        loc = np.searchsorted(union, need)
                        idx_parts.append(gw_offsets[(g, s)] + loc)
                    s2[g][di] = (
                        np.concatenate(
                            [s2[g][di]] + [p.astype(np.int64) for p in idx_parts]
                        )
                        if idx_parts
                        else s2[g][di]
                    )

        S2 = max(1, max(len(s2[g][di]) for g in range(n) for di in range(n_intra)))
        S2 = -(-S2 // pad_to) * pad_to
        intra_send = np.zeros((n, n_intra, S2), np.int32)
        recv_tot = [0] * n
        for g in range(n):
            for di in range(n_intra):
                rows = s2[g][di]
                intra_send[g, di, : len(rows)] = rows
        for dn in range(n_inter):
            for di in range(n_intra):
                d = rank(dn, di)
                recv_tot[d] = sum(
                    len(s2[rank(dn, si)][di]) for si in range(n_intra)
                )
        R2 = max(1, max(recv_tot))
        R2 = -(-R2 // pad_to) * pad_to
        intra_sel = np.full((n, R2), n_intra * S2, np.int32)
        intra_valid = np.zeros((n, R2), bool)
        for dn in range(n_inter):
            for di in range(n_intra):
                d = rank(dn, di)
                pos = 0
                for si in range(n_intra):
                    g = rank(dn, si)
                    ln = len(s2[g][di])
                    intra_sel[d, pos : pos + ln] = si * S2 + np.arange(ln)
                    intra_valid[d, pos : pos + ln] = True
                    pos += ln

        inter_rows = tuple(
            sum(len(s1[s][dn]) for dn in range(n_inter)) for s in range(n)
        )

        # intra-level hop schedule: the hop world is the intra subgroup;
        # the per-hop max must hold across every node (one buffer size per
        # hop), so collapse nodes into an effective [n_intra, n_intra] size
        # matrix
        sizes_intra = np.zeros((n_intra, n_intra), dtype=np.int64)
        for si in range(n_intra):
            for di in range(n_intra):
                sizes_intra[si, di] = max(
                    len(s2[rank(dn, si)][di]) for dn in range(n_inter)
                )
        hop_specs = _hop_padded_sizes(sizes_intra, pad_to)
        impl_resolved, reason = _resolve_impl(
            impl, hop_specs, n_intra, S2
        )
        intra_hops: tuple[HopPlan, ...] = ()
        if impl_resolved == "hops":
            # dst-side offsets of the (gateway si asc) final recv layout
            plans = []
            for k, Sk in hop_specs:
                h_send = np.zeros((n, Sk), np.int32)
                h_recv = np.full((n, Sk), R2, np.int32)  # pads -> trash
                h_seg = np.full((n, Sk), R1, np.int32)  # pads -> the R1 sentinel
                for dn in range(n_inter):
                    for si in range(n_intra):
                        g = rank(dn, si)
                        rows = s2[g][(si + k) % n_intra]
                        h_send[g, : len(rows)] = rows
                        h_seg[g, : len(rows)] = rows
                    for di in range(n_intra):
                        d = rank(dn, di)
                        si_src = (di - k) % n_intra
                        rows = s2[rank(dn, si_src)][di]
                        off = sum(
                            len(s2[rank(dn, sj)][di])
                            for sj in range(si_src)
                        )
                        h_recv[d, : len(rows)] = off + np.arange(len(rows))
                plans.append(
                    HopPlan(
                        shift=k,
                        size=Sk,
                        send_idx=h_send,
                        recv_pos=h_recv,
                        seg_ids=h_seg,
                    )
                )
            intra_hops = tuple(plans)

        # the reduce's owner rows of each level, from its pair counts
        # (pads take the level's input-row count as a dropped sentinel)
        inter_seg = np.zeros((n, n_inter, S1), np.int32)
        intra_seg = np.full((n, n_intra, S2), R1, np.int32)
        for s in range(n):
            inter_seg[s] = num_local_rows[s]
            for dn in range(n_inter):
                inter_seg[s, dn, : len(s1[s][dn])] = s1[s][dn]
            for di in range(n_intra):
                intra_seg[s, di, : len(s2[s][di])] = s2[s][di]
        inter_level = GroupCollectiveMeta(
            cp_size=n_inter, max_send=S1, max_recv=R1, send_total=inter_rows,
            recv_total=tuple(gw_len), send_idx=inter_send, recv_sel=inter_sel,
            recv_valid=inter_valid, seg_ids=inter_seg, pad_to=pad_to, impl="a2a",
            impl_reason="hier_inter_level",
            local_rows_total=sum(len(s1[s][s // n_intra]) for s in range(n)),
        )
        intra_level = GroupCollectiveMeta(
            cp_size=n_intra, max_send=S2, max_recv=R2,
            send_total=tuple(sum(len(s2[g][di]) for di in range(n_intra)) for g in range(n)),
            recv_total=tuple(recv_tot), send_idx=intra_send, recv_sel=intra_sel,
            recv_valid=intra_valid, seg_ids=intra_seg, pad_to=pad_to, impl=impl_resolved,
            impl_reason=reason, hops=intra_hops,
            local_rows_total=sum(len(s2[g][g % n_intra]) for g in range(n)),
        )

        meta = HierGroupCollectiveMeta(
            n_inter=n_inter,
            n_intra=n_intra,
            inter_send_idx=inter_send,
            inter_recv_sel=inter_sel,
            inter_recv_valid=inter_valid,
            intra_send_idx=intra_send,
            intra_recv_sel=intra_sel,
            intra_recv_valid=intra_valid,
            recv_total=tuple(recv_tot),
            inter_rows_total=inter_rows,
            # duck-types GroupCollectiveMeta diagnostics: what a rank "sends"
            # is its dedup'd inter-hop payload
            send_total=inter_rows,
            pad_to=pad_to,
            impl=impl_resolved,
            impl_reason=reason,
            intra_hops=intra_hops,
            intra_true_rows=int(sum(recv_tot)),
            intra_local_rows=int(
                sum(
                    len(s2[rank(dn, si)][si])
                    for dn in range(n_inter)
                    for si in range(n_intra)
                )
            ),
            inter_level=inter_level,
            intra_level=intra_level,
        )
        from .. import telemetry

        telemetry.record_group_collective_build(meta)
        # reorder recv_sources to the actual final layout: (si asc, sn asc)
        ordered: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n)]
        for dn in range(n_inter):
            for di in range(n_intra):
                d = rank(dn, di)
                for si in range(n_intra):
                    for sn in range(n_inter):
                        s = rank(sn, si)
                        need = send_map[s][d]
                        if len(need):
                            ordered[d].append((s, np.asarray(need, np.int64)))
        return meta, ordered


def node_crossing_rows(comm, n_inter: int, n_intra: int) -> int:
    """Rows a cast moves between nodes of an (n_inter, n_intra) layout of
    the ranks (rank = node * n_intra + intra), counted at the receivers: a
    flat ``GroupCollectiveMeta``'s rows from a rank of another node; a
    ``HierGroupCollectiveMeta``'s inter-level rows from another node (each
    row once per destination node, after the dedup)."""
    if isinstance(comm, HierGroupCollectiveMeta):
        sel, valid, width = comm.inter_recv_sel, comm.inter_recv_valid, comm.inter_send_idx.shape[2]
        src_node = lambda g, sel_g: sel_g // width  # noqa: E731
    else:
        sel, valid, width = comm.recv_sel, comm.recv_valid, comm.max_send
        src_node = lambda g, sel_g: (sel_g // width) // n_intra  # noqa: E731
    total = 0
    for g in range(sel.shape[0]):
        rows = sel[g][valid[g]]
        total += int((src_node(g, rows) != g // n_intra).sum())
    return total


# -- the device side ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class HierRouting:
    """One rank's two levels of a :class:`HierGroupCollectiveMeta` on its
    device: the inter level's routing (group rank = node) and the intra
    level's (group rank = intra position, over the gateway buffer)."""

    inter: RankRouting
    intra: RankRouting


@functools.lru_cache(maxsize=512)
def hier_rank_routing(meta: HierGroupCollectiveMeta, rank: int, num_local_rows: int,
                      device: str) -> HierRouting:
    """cp rank ``rank``'s routing of ``meta`` as int64 tensors on
    ``device``, built once per (meta, rank, device)."""
    node, intra = divmod(rank, meta.n_intra)
    gateway_rows = int(meta.inter_recv_sel.shape[1])  # R1
    return HierRouting(
        inter=rank_routing(meta.inter_level, rank, num_local_rows, device, group_rank=node),
        intra=rank_routing(meta.intra_level, rank, gateway_rows, device, group_rank=intra),
    )


def group_cast_hier(x: torch.Tensor, hr: HierRouting, groups: HierCpGroups) -> torch.Tensor:
    """Two-hop multicast of this rank's rows ``x`` [T, ...]: the dedup'd
    inter-level cast into the gateway buffer [R1, ...], then the intra
    level's fan-out; returns the [R2, ...] rows this rank receives, in the
    (gateway asc, src node asc, gateway position) order, padded rows zero."""
    gw = group_cast(x, hr.inter, groups.inter)
    return group_cast(gw, hr.intra, groups.intra)


def group_reduce_hier(y: torch.Tensor, hr: HierRouting, groups: HierCpGroups) -> torch.Tensor:
    """The transpose of :func:`group_cast_hier`: partial rows ``y`` [R2, ...]
    flow back to their gateways over the intra subgroup and are summed
    there (rows several ranks of a node received from one source row add
    up at the gateway), then cross the inter subgroup once per unique row
    and are summed onto the owner rows; returns this rank's [T, ...] sums."""
    gw = cast_transpose(y, hr.intra, groups.intra)
    return cast_transpose(gw, hr.inter, groups.inter)


class GroupCastHier(torch.autograd.Function):
    """:func:`group_cast_hier` with :func:`group_reduce_hier` as its backward
    (the cotangent of a received row is pre-reduced at its gateway and
    then summed onto the row it came from)."""

    @staticmethod
    def forward(ctx, x, hr: HierRouting, groups: HierCpGroups):
        ctx.hr, ctx.groups = hr, groups
        return group_cast_hier(x, hr, groups)

    @staticmethod
    def backward(ctx, g):
        return group_reduce_hier(g.contiguous(), ctx.hr, ctx.groups), None, None
