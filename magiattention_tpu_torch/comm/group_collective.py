"""GroupCast / GroupReduce: zero-redundancy group collectives over a
``torch.distributed`` process group.

The port's counterpart of the JAX package's ``comm/group_collective.py``,
with the original MagiAttention's semantics: each rank's rows multicast to
a set of destination ranks (cast), and partial rows summed back onto their
owner ranks (reduce, the cast's transpose). The host side is a copy of the
JAX package's: :meth:`GroupCollectiveMeta.build` gives byte-identical
routing arrays and resolves the same implementation
(``MAGI_ATTENTION_GROUP_COLL_IMPL``):

- ``a2a``: one ``all_to_all_single`` per cast, every (src, dst) pair padded
  to the global max pair size S;
- ``hops``: hop k in 1..cp-1 trades with rank (r + k) mod cp through one
  ``batch_isend_irecv``, its buffer padded only to that hop's own max pair
  size; hop 0 (own rows) is a local gather, zero-volume hops are skipped;
- ``auto`` (default): per collective, by predicted wire volume
  (:func:`_resolve_impl`).

The recv layout is the same in both: rows in (src rank, send position)
order. On the device, each process holds its own routing row
(:func:`rank_routing`); :func:`group_cast` packs rows by ``send_idx``,
exchanges them and selects the received rows, :func:`cast_transpose` is
its transpose (index ops for the local pack and unpack), and
:class:`GroupCast` is the ``torch.autograd.Function`` whose backward is
that transpose, so that the dK/dV of rows another rank received come home;
:func:`group_reduce_sum` is the explicit GroupReduce with the sum op.
The runtimes cast through :func:`group_cast_m`, where the cast's chaos
injectors sit; the reduces carry theirs (``resilience/chaos.py``).
:func:`group_reduce_lse` is the GroupReduce with the LSE op, which brings
partial (out, lse) rows back to their owners and merges them there
(qo-comm): the transport is :class:`ReturnRows`, whose backward is a cast
of the cotangent rows, and the merge runs as torch ops under autograd.

Which buffers an exchange takes follows the group's backend, never a
caught error: NCCL exchanges the CUDA tensors as they are; gloo takes
CUDA tensors for the collectives in ``GLOO_CUDA_OPS`` and reads a host
pointer in its send/recv, so the hops' rows are staged through pinned
host buffers there (:func:`staging`); CPU tensors go as they are.

The collective recorder (:func:`record_collectives`) is the port's
counterpart of reading a jaxpr: while it is active, every collective the
comm layer issues (:func:`all_to_all_rows`, :func:`exchange`, and
``primitives.all_gather_v`` and the gradient all-reduce of
``primitives.replicated``) appends one :class:`CollectiveRecord`, named as
the JAX package's census names its primitives. ``live`` then issues the
call; ``dry`` issues nothing and returns zeros of the shape the call
returns, over a :class:`DryGroup` stand-in that carries the rank and the
group size, so one process can record every rank's sequence without a
wire (``analysis/trace_audit.py``, ``analysis/spmd_audit.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.correction import exp_where_finite
from ..resilience import chaos
from ..resilience.guards import quarantine_if_repair

NEG_INF = float("-inf")

# auto-mode volume bar: hop scheduling is picked when its scheduled rows
# fall strictly below this fraction of the a2a's `cp * max_send` buffer —
# the saving must beat more than the a2a's own (locally-copied) self chunk
# to justify cp-1 dependent exchanges in place of one fused all_to_all.
# Near-uniform pair sizes (dense causal
# over an even shard) stay on a2a; the skewed maps of varlen / SWA /
# block-sparse masks clear the bar by a wide margin.
AUTO_HOPS_MAX_VOLUME_FRACTION = 0.75


def _round_up_to(a: int, b: int) -> int:
    return -(-a // b) * b


def _pair_sizes(send_map) -> np.ndarray:
    """[cp, cp] int64: rows each (src, dst) pair moves."""
    cp = len(send_map)
    sizes = np.zeros((cp, cp), dtype=np.int64)
    for s in range(cp):
        assert len(send_map[s]) == cp
        for d in range(cp):
            sizes[s, d] = len(send_map[s][d])
    return sizes


def _hop_padded_sizes(
    sizes: np.ndarray, pad_to: int
) -> list[tuple[int, int]]:
    """Active hops of a send-size matrix: [(shift, padded Sk)] for every
    hop k in 0..cp-1 whose max pair size ``max_r sizes[r, (r+k) % cp]``
    is nonzero (hop 0 = self rows, a local copy)."""
    cp = sizes.shape[0]
    out = []
    for k in range(cp):
        m = int(max(sizes[r, (r + k) % cp] for r in range(cp)))
        if m:
            out.append((k, _round_up_to(m, pad_to)))
    return out


def _scheduled_rows(hop_specs, cp: int, max_send: int) -> tuple[int, int]:
    """(hops_scheduled, a2a_scheduled) rows per rank: the per-hop padded
    sums over wire-crossing hops (hop 0 is a local copy) vs the full
    ``cp * max_send`` buffer the globally-padded a2a allocates and
    ships."""
    hops_sched = sum(sz for k, sz in hop_specs if k % cp != 0)
    return hops_sched, cp * max_send


def _resolve_impl(
    impl: str, hop_specs, cp: int, max_send: int
) -> tuple[str, str]:
    """Resolve 'auto' to a concrete impl by predicted scheduled volume;
    returns (impl, reason). Strictly-below-threshold keeps near-uniform
    maps (where hop scheduling saves only the a2a's self chunk) on the
    single fused a2a."""
    from .. import env

    if impl not in env.GROUP_COLL_IMPLS:
        raise ValueError(
            f"MAGI_ATTENTION_GROUP_COLL_IMPL={impl!r} is not one of "
            f"{env.GROUP_COLL_IMPLS}"
        )
    if impl != "auto":
        return impl, "env_pinned"
    hops_sched, a2a_sched = _scheduled_rows(hop_specs, cp, max_send)
    if hops_sched == 0:
        # nothing crosses the wire: hops trace NO collective at all
        return "hops", "auto_zero_volume"
    if hops_sched < AUTO_HOPS_MAX_VOLUME_FRACTION * a2a_sched:
        return "hops", "auto_volume"
    return "a2a", "auto_near_uniform"


def predicted_volume_ratio(
    send_map, pad_to: int | None = None, impl: str | None = None
) -> tuple[float, str]:
    """(scheduled_rows / true_rows, resolved impl) that
    :meth:`GroupCollectiveMeta.build` would produce for this send map —
    sizes math only, no routing arrays. The overlap solver prices stage
    comm with this ratio so the timeline model sees the volume the
    selected impl will actually move, not the true-row lower bound and
    not the a2a's global-pad upper bound."""
    from .. import env

    if pad_to is None:
        pad_to = env.comm_pad_to()
    if impl is None:
        impl = env.group_coll_impl()
    sizes = _pair_sizes(send_map)
    cp = sizes.shape[0]
    S = _round_up_to(max(int(sizes.max()), 1), pad_to)
    hop_specs = _hop_padded_sizes(sizes, pad_to)
    resolved, _ = _resolve_impl(impl, hop_specs, cp, S)
    true_rows = int(sizes.sum())
    if resolved == "hops":
        scheduled = cp * sum(sz for k, sz in hop_specs if k % cp != 0)
    else:
        scheduled = cp * cp * S
    if true_rows == 0:
        return (1.0 if scheduled == 0 else float(scheduled)), resolved
    return scheduled / true_rows, resolved


@dataclasses.dataclass(frozen=True, eq=False)
class HopPlan:
    """One hop of the hop-scheduled collective: rank r exchanges with
    rank (r + shift) mod cp, buffer padded to this hop's own max pair
    size. ``shift == 0`` is the self hop (local gather/scatter, no
    collective)."""

    shift: int
    size: int  # Sk: padded rows this hop moves per rank
    send_idx: np.ndarray  # [cp, Sk] int32: [src, pos] -> src-local row
    recv_pos: np.ndarray  # [cp, Sk] int32: [dst, pos] -> recv-buffer row
    # (pads -> max_recv trash slot)
    seg_ids: np.ndarray  # [cp, Sk] int32: [owner, pos] -> owner row
    # (pads -> num_local_rows sentinel, contributes zero to the reduce)


@dataclasses.dataclass(frozen=True, eq=False)
class GroupCollectiveMeta:
    """Host-side routing plan for one group_cast (and its reverse reduce).

    Built from ``send_map[src][dst] = local row indices`` (numpy) via
    :meth:`build`. The stacked arrays have a leading cp axis; each rank's
    process takes its own row (:func:`rank_routing`).
    """

    cp_size: int
    max_send: int  # S: rows any rank sends to any one peer (padded)
    max_recv: int  # R: output rows any rank receives (padded)
    send_total: tuple[int, ...]  # valid send rows per rank (diagnostics)
    recv_total: tuple[int, ...]  # valid recv rows per rank

    send_idx: np.ndarray  # [cp, cp, S] int32: [src, dst, pos] -> src-local row
    recv_sel: np.ndarray  # [cp, R] int32: [dst, out_pos] -> flat (src*S+pos)
    recv_valid: np.ndarray  # [cp, R] bool: out_pos < recv_total[dst]
    seg_ids: np.ndarray  # [cp, cp, S] int32: [owner, src, pos] -> owner row
    # (pad positions -> num_segments sentinel, dropped by the reduce)

    # hop-scheduled realization: built when the resolved impl is
    # 'hops'; same recv layout, per-hop exact-size buffers
    pad_to: int = 8
    impl: str = "a2a"
    impl_reason: str = "legacy"
    hops: tuple[HopPlan, ...] = ()
    local_rows_total: int = 0  # self-pair (src == dst) rows, never on wire

    @staticmethod
    def build(
        send_map: Sequence[Sequence[np.ndarray]],
        num_local_rows: Sequence[int],
        pad_to: int | None = None,
        impl: str | None = None,
    ) -> "GroupCollectiveMeta":
        """``send_map[src][dst]``: int array of src-local rows sent src->dst.

        ``num_local_rows[rank]``: rank's local row count (segment count for
        the reverse reduce). Output layout at each dst: concatenation over
        src ranks (rank order) of received rows (send order) — the a2av
        convention the solver's CommMeta is built around, preserved
        bit-identically by both impls.

        ``pad_to`` defaults to ``MAGI_ATTENTION_COMM_PAD_TO`` and ``impl``
        to ``MAGI_ATTENTION_GROUP_COLL_IMPL`` ('auto' resolves here, by
        predicted wire volume).
        """
        from .. import env

        if pad_to is None:
            pad_to = env.comm_pad_to()
        if impl is None:
            impl = env.group_coll_impl()
        cp = len(send_map)
        sizes = _pair_sizes(send_map)
        S = max(int(sizes.max()), 1)
        S = -(-S // pad_to) * pad_to
        recv_tot = sizes.sum(axis=0)  # rows arriving at each dst
        R = max(int(recv_tot.max()), 1)
        R = -(-R // pad_to) * pad_to

        send_idx = np.zeros((cp, cp, S), dtype=np.int32)
        # pad positions point at the trash slot cp*S (one past the real flat
        # recv buffer) so reverse scatters cannot clobber real rows
        recv_sel = np.full((cp, R), cp * S, dtype=np.int32)
        recv_valid = np.zeros((cp, R), dtype=bool)
        seg_ids = np.full((cp, cp, S), 0, dtype=np.int32)
        for s in range(cp):
            for d in range(cp):
                idx = np.asarray(send_map[s][d], dtype=np.int32).reshape(-1)
                assert (idx < num_local_rows[s]).all() if idx.size else True
                send_idx[s, d, : idx.size] = idx
                # reverse direction: rows owner s sent to d come back from d;
                # at owner s, recv row (d, pos) reduces into local row idx[pos]
                seg_ids[s, d, : idx.size] = idx
                seg_ids[s, d, idx.size :] = num_local_rows[s]  # drop sentinel
        for d in range(cp):
            pos = 0
            for s in range(cp):
                n = int(sizes[s, d])
                recv_sel[d, pos : pos + n] = s * S + np.arange(n)
                recv_valid[d, pos : pos + n] = True
                pos += n

        hop_specs = _hop_padded_sizes(sizes, pad_to)
        impl_resolved, reason = _resolve_impl(impl, hop_specs, cp, S)
        hops: tuple[HopPlan, ...] = ()
        if impl_resolved == "hops":
            try:
                chaos.maybe_fail("hops_build_error")
                hops = _hop_plans(send_map, num_local_rows, sizes, hop_specs, R)
            except Exception as exc:  # noqa: BLE001 — the degradation path
                # a failed hop-plan build falls back to the always-available
                # globally padded a2a collective (correct, more wire volume),
                # never silently
                from .. import telemetry

                telemetry.record_degraded_path("hops_build_error")
                telemetry.get_logger("resilience").warning(
                    "hop-schedule build failed (%s: %s) — degrading this collective to the "
                    "a2a impl", type(exc).__name__, exc)
                impl_resolved, reason = "a2a", "degraded_hops_build_error"
                hops = ()
        meta = GroupCollectiveMeta(
            cp_size=cp,
            max_send=S,
            max_recv=R,
            send_total=tuple(int(x) for x in sizes.sum(axis=1)),
            recv_total=tuple(int(x) for x in recv_tot),
            send_idx=send_idx,
            recv_sel=recv_sel,
            recv_valid=recv_valid,
            seg_ids=seg_ids,
            pad_to=pad_to,
            impl=impl_resolved,
            impl_reason=reason,
            hops=hops,
            local_rows_total=int(np.trace(sizes)),
        )
        from .. import telemetry

        telemetry.record_group_collective_build(meta)
        return meta

    # ---- volume accounting (rows; the interface layer resolves bytes) ----

    @property
    def padded_rows_per_rank(self) -> int:
        """Legacy a2a payload rows per rank (`cp * max_send`): what the
        globally-padded all_to_all ships regardless of impl choice."""
        return self.cp_size * self.max_send

    @property
    def comm_bytes_per_rank(self) -> int:
        """Padded all-to-all payload rows (volume accounting, per element).

        Back-compat alias of :attr:`padded_rows_per_rank`; prefer
        :attr:`scheduled_rows_per_rank` for what the selected impl will
        actually move."""
        return self.padded_rows_per_rank

    @property
    def scheduled_rows_per_rank(self) -> int:
        """Payload rows per rank the SELECTED impl schedules: the full
        ``cp * max_send`` buffer for a2a, the sum of per-hop padded sizes
        over wire-crossing hops (shift != 0) for hop scheduling."""
        if self.impl == "hops":
            return sum(
                h.size for h in self.hops if h.shift % self.cp_size != 0
            )
        return self.padded_rows_per_rank

    @property
    def true_rows_total(self) -> int:
        """Real routed rows across the group (no padding)."""
        return sum(self.send_total)

    @property
    def scheduled_rows_total(self) -> int:
        return self.cp_size * self.scheduled_rows_per_rank

    @property
    def padding_overhead_ratio(self) -> float:
        """Group-wide scheduled rows / true rows ON THE PAIRS THE IMPL
        SCHEDULES (>= 1.0 when anything is scheduled; 0.0 otherwise):
        pure padding waste of the selected impl. The a2a buffer carries
        every pair including self rows; hop scheduling moves self rows
        by local copy, so its base excludes them — cross-impl volume is
        compared via :attr:`scheduled_rows_per_rank`, not this ratio."""
        base = self.true_rows_total
        if self.impl == "hops":
            base -= self.local_rows_total
        return (self.scheduled_rows_total / base) if base else 0.0

    # ---- per-impl device array layouts ----------------------------------
    # The plan's flattened operand stream ships exactly these, in this
    # order; consumers (dist_attn_local, qo_comm_attn_local, the timeline
    # profiler) count via num_cast_arrays / num_reduce_arrays.

    def cast_device_arrays(self) -> tuple[np.ndarray, ...]:
        """Arrays the cast (and its AD transpose) needs: a2a ->
        (send_idx, recv_sel, recv_valid); hops -> (send_idx, recv_pos)
        per active hop."""
        if self.impl == "hops":
            out: list[np.ndarray] = []
            for h in self.hops:
                out += [h.send_idx, h.recv_pos]
            return tuple(out)
        return (self.send_idx, self.recv_sel, self.recv_valid)

    def reduce_device_arrays(self) -> tuple[np.ndarray, ...]:
        """Superset layout for casts plus explicit reduces: a2a ->
        (send_idx, recv_sel, recv_valid, seg_ids); hops ->
        (send_idx, recv_pos, seg_ids) per active hop."""
        if self.impl == "hops":
            out: list[np.ndarray] = []
            for h in self.hops:
                out += [h.send_idx, h.recv_pos, h.seg_ids]
            return tuple(out)
        return (self.send_idx, self.recv_sel, self.recv_valid, self.seg_ids)

    @property
    def num_cast_arrays(self) -> int:
        return 2 * len(self.hops) if self.impl == "hops" else 3

    @property
    def num_reduce_arrays(self) -> int:
        return 3 * len(self.hops) if self.impl == "hops" else 4


def _hop_plans(send_map, num_local_rows, sizes, hop_specs, R) -> tuple[HopPlan, ...]:
    """The per-hop routing arrays of :meth:`GroupCollectiveMeta.build`'s
    hops impl."""
    cp = len(send_map)
    # dst-side segment offsets of the (src-rank-major) recv layout
    offsets = np.zeros((cp, cp), dtype=np.int64)
    offsets[1:] = np.cumsum(sizes, axis=0)[:-1]  # [src, dst]
    plans = []
    for k, Sk in hop_specs:
        h_send = np.zeros((cp, Sk), dtype=np.int32)
        h_recv = np.full((cp, Sk), R, dtype=np.int32)
        h_seg = np.zeros((cp, Sk), dtype=np.int32)
        for r in range(cp):
            d = (r + k) % cp
            idx = np.asarray(send_map[r][d], dtype=np.int32).reshape(-1)
            h_send[r, : idx.size] = idx
            h_seg[r, : idx.size] = idx
            h_seg[r, idx.size :] = num_local_rows[r]
        for d in range(cp):
            s = (d - k) % cp
            n = int(sizes[s, d])
            h_recv[d, :n] = offsets[s, d] + np.arange(n)
        plans.append(HopPlan(shift=k, size=Sk, send_idx=h_send, recv_pos=h_recv, seg_ids=h_seg))
    return tuple(plans)


# -- the device side ---------------------------------------------------------------

# collectives that gloo's process group runs on CUDA tensors (it copies
# them through the host itself); its send/recv read a host pointer and so
# take host tensors only
GLOO_CUDA_OPS = frozenset({"all_to_all_single", "all_gather", "all_reduce", "broadcast"})


# -- the collective recorder -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A stand-in process group for a dry recording: this rank's position
    ``rank`` in a group of ``size`` ranks, and the name of the axis (for a
    hierarchical cast, the level) the group spans. No wire is behind it:
    pass it only under ``record_collectives("dry")``."""

    rank: int
    size: int
    axis: str = "cp"


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective the comm layer issued (or, dry, would have issued)."""

    op: str  # the JAX census's name: all_to_all | ppermute | all_gather | psum
    axis: str  # "cp" for a process group; a DryGroup's own axis name
    rank: int  # this rank's position in the group
    size: int  # the group's size
    peers: tuple[int, int] | None  # a ppermute's (send to, receive from) group ranks
    shape: tuple[int, ...]  # the payload this rank puts in
    dtype: str


class _Recording:
    def __init__(self, mode: str):
        self.mode = mode
        self.records: list[CollectiveRecord] = []


_RECORDINGS: list[_Recording] = []


def recording() -> bool:
    """Whether a :func:`record_collectives` block is active (the only cost
    of the recorder when none is)."""
    return bool(_RECORDINGS)


@contextlib.contextmanager
def record_collectives(mode: str = "live"):
    """Record every collective the comm layer issues inside the block;
    yields the list the :class:`CollectiveRecord` s are appended to, in
    issue order. ``live`` records and then issues the real call; ``dry``
    records, issues nothing and returns zeros of the shape the call returns
    (groups may be :class:`DryGroup` s). Blocks nest: a record goes to every
    active one, and any active dry block makes the call dry."""
    if mode not in ("live", "dry"):
        raise ValueError(f"record_collectives: mode {mode!r} must be 'live' or 'dry'")
    rec = _Recording(mode)
    _RECORDINGS.append(rec)
    try:
        yield rec.records
    finally:
        _RECORDINGS.remove(rec)


def group_rank(group) -> int:
    """This process's rank in ``group``: a :class:`DryGroup`'s own, else
    ``torch.distributed``'s."""
    return group.rank if isinstance(group, DryGroup) else dist.get_rank(group)


def group_size(group) -> int:
    """``group``'s size: a :class:`DryGroup`'s own, else
    ``torch.distributed``'s."""
    return group.size if isinstance(group, DryGroup) else dist.get_world_size(group)


def record_collective(op: str, group, payload: torch.Tensor, peers=None) -> bool:
    """Append one record to every active recording; True when the call
    must not be issued (a dry recording is active). A :class:`DryGroup`
    outside a dry recording raises: it has no wire."""
    dry = isinstance(group, DryGroup)
    rec = CollectiveRecord(op, group.axis if dry else "cp", group_rank(group),
                           group_size(group), peers, tuple(payload.shape), str(payload.dtype))
    skip = False
    for r in _RECORDINGS:
        r.records.append(rec)
        skip = skip or r.mode == "dry"
    if dry and not skip:
        raise ValueError(f"a DryGroup has no wire: {op} over it needs record_collectives('dry')")
    return skip


def staging(group, device: torch.device, op: str) -> bool:
    """True when ``op`` on ``device`` tensors must go through host buffers
    because ``group``'s backend does not take them: gloo on CUDA tensors
    for an op outside :data:`GLOO_CUDA_OPS`. Decided from the backend the
    caller's group has, never by trying."""
    return (
        device.type == "cuda"
        and dist.get_backend(group) == "gloo"
        and op not in GLOO_CUDA_OPS
    )


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (waits for the copy)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_to_all_rows(send: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all over the leading axis: block j of ``send``
    goes to rank j, block i of the result came from rank i (every backend
    takes the tensors where they are: gloo's all-to-all copies CUDA tensors
    through the host itself)."""
    if recording() and record_collective("all_to_all", group, send):
        return torch.zeros_like(send)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def exchange(send: torch.Tensor, to_rank: int, from_rank: int, group) -> torch.Tensor:
    """Send ``send`` to group rank ``to_rank`` and receive a buffer of the
    same shape from ``from_rank``: one ``batch_isend_irecv``, the
    ``ppermute`` of the JAX census."""
    if recording() and record_collective("ppermute", group, send,
                                         (int(to_rank), int(from_rank))):
        return torch.zeros_like(send)
    send = send.contiguous()
    staged = staging(group, send.device, "batch_isend_irecv")
    s = _host(send) if staged else send
    r = torch.empty_like(s)
    ops = [
        dist.P2POp(dist.isend, s, dist.get_global_rank(group, to_rank), group),
        dist.P2POp(dist.irecv, r, dist.get_global_rank(group, from_rank), group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return r.to(send.device, non_blocking=True) if staged else r


@dataclasses.dataclass(frozen=True, eq=False)
class HopRouting:
    """One hop of a rank's hop-scheduled routing: send ``size`` rows
    (``send_idx``, pads repeat row 0) to rank + shift, receive ``size`` from
    rank - shift whose valid prefix lands at ``recv_pos``; in the reduce,
    the rows sent back land on the owner rows ``seg``."""

    shift: int
    size: int
    send_idx: torch.Tensor  # [size] int64
    recv_pos: torch.Tensor  # [n_recv] int64, the valid prefix
    seg: torch.Tensor  # [n_send] int64, the valid prefix


@dataclasses.dataclass(frozen=True, eq=False)
class RankRouting:
    """One rank's row of a :class:`GroupCollectiveMeta` as index tensors on
    its device: what :func:`group_cast` and :func:`group_reduce_sum` need."""

    impl: str
    cp_size: int
    rank: int
    num_local_rows: int  # T: rows of the cast's input on this rank
    max_send: int  # S
    max_recv: int  # R: rows of the cast's output
    # a2a
    send_idx: torch.Tensor | None  # [cp * S] int64
    recv_sel: torch.Tensor | None  # [n_recv] int64 into the flat recv buffer
    back_pos: torch.Tensor | None  # [m] int64: valid positions of the sent-back buffer
    back_rows: torch.Tensor | None  # [m] int64: their owner rows
    # hops
    hops: tuple[HopRouting, ...] = ()
    # the meta's scheduled / true rows (``telemetry.record_comm_op``)
    padding_overhead_ratio: float = 1.0


@functools.lru_cache(maxsize=512)
def rank_routing(meta: GroupCollectiveMeta, rank: int, num_local_rows: int,
                 device: str, group_rank: int | None = None) -> RankRouting:
    """``rank``'s routing row of ``meta`` as int64 tensors on ``device``,
    built once per (meta, rank, device). ``group_rank`` is the rank's
    position in the group the collective runs over, where that group is
    not the one the rows are indexed by (a level of a hierarchical cast:
    row = cp rank, group = its inter or intra subgroup); default ``rank``."""

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(device)

    cp, R = meta.cp_size, meta.max_recv
    me = rank if group_rank is None else group_rank
    if meta.impl == "hops":
        hops = []
        for h in meta.hops:
            recv_pos = h.recv_pos[rank]
            seg = h.seg_ids[rank]
            hops.append(HopRouting(
                shift=h.shift, size=h.size, send_idx=t(h.send_idx[rank]),
                recv_pos=t(recv_pos[recv_pos < R]), seg=t(seg[seg < num_local_rows]),
            ))
        return RankRouting("hops", cp, me, num_local_rows, meta.max_send, R,
                           None, None, None, None, tuple(hops), meta.padding_overhead_ratio)
    n_recv = int(meta.recv_valid[rank].sum())
    seg = meta.seg_ids[rank].reshape(-1)
    pos = np.flatnonzero(seg < num_local_rows)
    return RankRouting(
        "a2a", cp, me, num_local_rows, meta.max_send, R,
        t(meta.send_idx[rank].reshape(-1)), t(meta.recv_sel[rank, :n_recv]),
        t(pos), t(seg[pos]), padding_overhead_ratio=meta.padding_overhead_ratio,
    )


def group_cast(x: torch.Tensor, rt: RankRouting, group) -> torch.Tensor:
    """Multicast this rank's rows ``x`` [T, ...] along the routing; returns
    the [R, ...] rows this rank receives, in (src rank, send position)
    order, padded rows zero. A ``straggler`` chaos clause holds its hop's
    received rows back (bit for bit unchanged)."""
    out = x.new_zeros((rt.max_recv,) + tuple(x.shape[1:]))
    if rt.impl == "hops":
        straggle = chaos.enabled()
        for h in rt.hops:
            buf = x.index_select(0, h.send_idx)
            if h.shift % rt.cp_size:
                buf = exchange(buf, (rt.rank + h.shift) % rt.cp_size,
                               (rt.rank - h.shift) % rt.cp_size, group)
            if straggle:
                buf = chaos.straggler_delay(buf, h.shift)
            n = h.recv_pos.shape[0]
            out.index_copy_(0, h.recv_pos, buf[:n])
        return out
    recv = all_to_all_rows(x.index_select(0, rt.send_idx), group)
    n = rt.recv_sel.shape[0]
    out[:n] = recv.index_select(0, rt.recv_sel)
    return out


def group_cast_m(x: torch.Tensor, rt: RankRouting, group) -> torch.Tensor:
    """The cast as the runtimes run it: :class:`GroupCast` (differentiable),
    then the ``corrupt_cast`` and ``permute_cast`` chaos injectors on the
    received rows (the JAX package's ``group_cast_m``), gated on this rank
    of the flat group. They run outside the autograd Function, so autograd
    sees ordinary ops; off, nothing runs."""
    out = GroupCast.apply(x, rt, group)
    if chaos.enabled():
        out = chaos.corrupt_cast_payload(out, rank=rt.rank)
    return out


def group_reduce_sum(y: torch.Tensor, rt: RankRouting, group) -> torch.Tensor:
    """The GroupReduce with the sum op: partial rows ``y`` [R, ...] in the
    cast's output layout go back to their owners and are summed onto the
    owner rows; returns this rank's [T, ...] sums (zero for rows it sent
    nowhere). A ``corrupt_reduce`` chaos clause plants its value into one
    partial row first (the JAX package's ``group_reduce_sum_m``); the
    cast's own backward is :func:`cast_transpose`, with no hook, as the
    JAX package's transpose of the cast has none."""
    from .. import telemetry

    telemetry.record_comm_op(rt, "reduce_sum")
    if chaos.enabled():
        y = chaos.corrupt_reduce_payload(y, rank=rt.rank)
    return cast_transpose(y, rt, group)


def cast_transpose(y: torch.Tensor, rt: RankRouting, group) -> torch.Tensor:
    """The transpose of :func:`group_cast`: the rows of ``y`` [R, ...] summed
    back onto the rows of this rank they came from ([T, ...])."""
    acc = y.new_zeros((rt.num_local_rows,) + tuple(y.shape[1:]))
    if rt.impl == "hops":
        for h in rt.hops:
            n_recv = h.recv_pos.shape[0]
            back = y.new_zeros((h.size,) + tuple(y.shape[1:]))
            back[:n_recv] = y.index_select(0, h.recv_pos)
            if h.shift % rt.cp_size:
                back = exchange(back, (rt.rank - h.shift) % rt.cp_size,
                                (rt.rank + h.shift) % rt.cp_size, group)
            n_send = h.seg.shape[0]
            acc.index_add_(0, h.seg, back[:n_send])
        return acc
    back = y.new_zeros((rt.cp_size * rt.max_send,) + tuple(y.shape[1:]))
    n = rt.recv_sel.shape[0]
    back.index_copy_(0, rt.recv_sel, y[:n])
    recv = all_to_all_rows(back, group)
    acc.index_add_(0, rt.back_rows, recv.index_select(0, rt.back_pos))
    return acc


class GroupCast(torch.autograd.Function):
    """:func:`group_cast` with :func:`cast_transpose` as its backward
    (the cotangent of a received row is summed onto the row it came from:
    a2a for an a2a routing, the hops' exchanges for a hops routing)."""

    @staticmethod
    def forward(ctx, x, rt: RankRouting, group):
        ctx.rt, ctx.group = rt, group
        return group_cast(x, rt, group)

    @staticmethod
    def backward(ctx, g):
        return cast_transpose(g.contiguous(), ctx.rt, ctx.group), None, None


class ReturnRows(torch.autograd.Function):
    """The transport of a GroupReduce: partial rows ``y`` [R, ...] in the
    cast's output layout go back to the ranks that own them. Returns one
    tensor per part of the routing (a2a: one; hops: one per active hop, in
    hop order): the rows that arrive at this rank, in its send order, the
    pads of the wire buffers filled with ``fill`` (-inf for an lse
    payload, so that a pad would never add to a denominator). Linear in
    ``y``: the backward casts the cotangent rows back the way they came."""

    @staticmethod
    def forward(ctx, y, rt: RankRouting, group, fill: float):
        ctx.rt, ctx.group, ctx.n = rt, group, y.shape[0]
        tail = tuple(y.shape[1:])
        if rt.impl == "hops":
            parts = []
            for h in rt.hops:
                back = y.new_full((h.size,) + tail, fill)
                back[: h.recv_pos.shape[0]] = y.index_select(0, h.recv_pos)
                if h.shift % rt.cp_size:
                    back = exchange(back, (rt.rank - h.shift) % rt.cp_size,
                                    (rt.rank + h.shift) % rt.cp_size, group)
                parts.append(back[: h.seg.shape[0]])
            return tuple(parts)
        back = y.new_full((rt.cp_size * rt.max_send,) + tail, fill)
        back.index_copy_(0, rt.recv_sel, y[: rt.recv_sel.shape[0]])
        return (all_to_all_rows(back, group).index_select(0, rt.back_pos),)

    @staticmethod
    def backward(ctx, *grads):
        rt, group = ctx.rt, ctx.group
        g0 = grads[0]
        gy = g0.new_zeros((ctx.n,) + tuple(g0.shape[1:]))
        if rt.impl == "hops":
            for h, g in zip(rt.hops, grads):
                buf = g.new_zeros((h.size,) + tuple(g.shape[1:]))
                buf[: g.shape[0]] = g
                if h.shift % rt.cp_size:
                    buf = exchange(buf, (rt.rank + h.shift) % rt.cp_size,
                                   (rt.rank - h.shift) % rt.cp_size, group)
                gy.index_add_(0, h.recv_pos, buf[: h.recv_pos.shape[0]])
            return gy, None, None, None
        back = g0.new_zeros((rt.cp_size * rt.max_send,) + tuple(g0.shape[1:]))
        back.index_copy_(0, rt.back_pos, g0)
        back = all_to_all_rows(back, group)
        gy[: rt.recv_sel.shape[0]] = back.index_select(0, rt.recv_sel)
        return gy, None, None, None


def return_rows(y: torch.Tensor, rt: RankRouting, group,
                fill: float = 0.0) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:class:`ReturnRows` with the owner row of each arriving row: a list
    of (rows, owner rows) per part of the routing."""
    if rt.impl == "hops":
        if not rt.hops:
            return []
        segs = [h.seg for h in rt.hops]
    else:
        segs = [rt.back_rows]
    return list(zip(ReturnRows.apply(y, rt, group, fill), segs))


def group_reduce_lse(
    out_partial: torch.Tensor,  # [R, h, d] partial outputs, the cast's output layout
    lse_partial: torch.Tensor,  # [R, h] their lse (-inf where a row has no keys)
    out_acc: torch.Tensor,  # [T, h, d] this rank's own partial out
    lse_acc: torch.Tensor,  # [T, h] and its lse
    rt: RankRouting,
    group,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GroupReduce with the LSE op: the partial (out, lse) rows go back to
    their owners and merge there with the accumulator as one more
    contribution, lse = log sum exp(lse_i), out = sum exp(lse_i - lse)
    out_i. Rows nobody contributed to keep (out_acc, lse_acc). The port's
    counterpart of the JAX package's ``group_reduce_lse`` (a2a),
    ``hop_reduce_lse`` (hops, merged hop by hop in hop order) and
    ``group_reduce_lse_m``, with the same two-pass segment logsumexp; a
    row's running max is held out of the gradient (the result does not
    depend on it). Differentiable in all four tensors; rows covered by no
    one get finite (zero) gradients. Returns (out in ``out_acc``'s dtype,
    lse in f32 or wider).

    Resilience (the JAX package's ``group_reduce_lse_m``): a
    ``corrupt_reduce`` chaos clause plants its value into one row of each
    partial payload, then under ``MAGI_ATTENTION_GUARD=repair`` the bad
    partial rows are quarantined (site ``"reduce_lse"``), so that each
    merges as a no-op."""
    from .. import telemetry

    telemetry.record_comm_op(rt, "reduce_lse")
    if chaos.enabled():
        out_partial = chaos.corrupt_reduce_payload(out_partial, rank=rt.rank)
        lse_partial = chaos.corrupt_reduce_payload(lse_partial, rank=rt.rank)
    out_partial, lse_partial = quarantine_if_repair(out_partial, lse_partial, "reduce_lse")
    parts_out = return_rows(out_partial, rt, group, 0.0)
    if not parts_out:
        return out_acc, lse_acc
    parts_lse = return_rows(lse_partial, rt, group, NEG_INF)
    acc_t = torch.promote_types(lse_partial.dtype, torch.float32)
    # pass 1: each owner row's max over every contribution, its own included
    m = lse_acc.detach().to(acc_t).clone()
    for lse_k, seg in parts_lse:
        idx = seg.view(-1, 1).expand(-1, lse_k.shape[1])
        m.scatter_reduce_(0, idx, lse_k.detach().to(acc_t), "amax", include_self=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    # pass 2: weights and weighted sums, accumulated part by part
    l_remote = torch.zeros(lse_acc.shape, dtype=acc_t, device=lse_acc.device)
    out_remote = torch.zeros(out_acc.shape, dtype=acc_t, device=out_acc.device)
    for (out_k, seg), (lse_k, _) in zip(parts_out, parts_lse):
        w = exp_where_finite(lse_k, lse_k.to(acc_t) - m_safe.index_select(0, seg))
        l_remote = l_remote + torch.zeros_like(l_remote).index_add(0, seg, w)
        out_remote = out_remote + torch.zeros_like(out_remote).index_add(
            0, seg, w[..., None] * out_k.to(acc_t))
    l_local = exp_where_finite(lse_acc, lse_acc.to(acc_t) - m_safe)
    l_tot = l_remote + l_local
    covered = l_tot > 0
    lse_new = torch.where(covered, m_safe + torch.log(l_tot.clamp_min(1e-38)),
                          torch.full_like(l_tot, NEG_INF))
    out_new = out_remote + l_local[..., None] * out_acc.to(acc_t)
    denom = torch.where(covered, l_tot, torch.ones_like(l_tot))[..., None]
    return (out_new / denom).to(out_acc.dtype), lse_new
