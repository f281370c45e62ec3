"""User-facing key-cached interface of context-parallel attention.

The port's counterpart of the JAX package's ``api/interface.py`` (the
subset on the training path), with the original MagiAttention's PyTorch
signature: a ``torch.distributed`` process group of the cp ranks
(``cp_group``, one process per rank) in place of a mesh and its axis, and
an explicit ``device``. All planning (dispatch solve, hole ranges, comm
routing, per-rank kernel tables) happens once per unique (mask, shapes,
group, flags) under a frozen hashable :class:`DistAttnRuntimeKey`; the hot
path is a dictionary lookup and the rank's kernels and casts::

    key = magi_attn_varlen_key(cu_seqlens, total, group, num_heads=(hq, hk),
                               head_dim=d)
    q_local = dispatch(q, key)              # global -> this rank's shard
    out, meta = calc_attn(q_local, k_local, v_local, key)
    out_global = undispatch(out, key)       # every rank's shard, natural order

Every rank holds the global tensors and calls the same sequence. Entry
points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"`` (the kernels' plain versions); without a card they raise.

The plan variants:

- hierarchical two-level comm: pass ``comm.make_hier_cp_groups(group,
  n_inter, n_intra)`` as ``cp_group`` (the JAX package's ``cp_axis=(inter,
  intra)``); each cast then sends a row that several ranks of a node need
  across nodes once. Dispatch, undispatch and the max-logit all-reduce run
  over the flat group;
- cross-attention (:func:`magi_attn_cross_key`): queries and memory are
  different sequences, dispatched by ``dispatch`` and ``dispatch_kv``;
- a new mask on an existing dispatch
  (:func:`make_flex_key_for_new_mask_after_dispatch` and its varlen twin):
  hybrid layer stacks share one token permutation;
- :func:`roll` shifts a dispatched tensor along the global sequence;
- a new mask every call (packed batches whose documents move, growing
  shapes): under ``MAGI_ATTENTION_PLAN_REUSE=bucket`` an exact-key miss
  canonicalises the mask onto length buckets
  (``meta/plan_fingerprint.py``), and a request whose canonical mask was
  planned before is served by a :class:`BucketedDistAttnRuntimeMgr`: the
  canonical plan and kernel parameters, reached through three padded-index
  tables, with no solver work. :func:`clear_cache` drops both cache levels.

Flags: ``MAGI_ATTENTION_QO_COMM`` plans qo-comm (``parallel/qo_comm.py``)
in place of the K/V-comm plan; ``MAGI_ATTENTION_AUTO_RANGE_MERGE`` merges
the slices (``ops/range_merge.py``) and ``MAGI_ATTENTION_SANITY_CHECK``
then checks them for overlapping coverage, both before the key is made;
``MAGI_ATTENTION_HIERARCHICAL_COMM`` requires the two-level groups;
``MAGI_ATTENTION_PLAN_REUSE`` picks the plan reuse above and
``MAGI_ATTENTION_PLAN_CACHE_SIZE`` sizes its cache;
``MAGI_ATTENTION_KERNEL_BACKEND`` picks the kernels or the plain forwards
(``env.kernel_backend``) and is part of the key. :func:`check_flag_comb`
refuses the combinations the JAX package refuses, so that no flag is taken
and then ignored.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from .. import env, telemetry
from ..common.enum import AttnMaskType
from ..common.forward_meta import AttnForwardMeta
from ..common.ranges import AttnRanges
from ..common.axes import cp_axis_names, split_cp_group
from ..config import DistAttnConfig
from ..meta.dispatch_meta import (
    DispatchMeta,
    make_cross_attn_dispatch_meta,
    make_dispatch_meta_from_qk_ranges,
    make_global_bucket_from_qk_ranges,
)
from ..meta.plan_fingerprint import (
    PlanReuseCache,
    ReuseEntry,
    canonicalize_mask,
    make_plan_fingerprint,
    try_incremental_update,
)
from ..meta.solver.dispatch_solver import DispatchConfig
from ..meta.solver.overlap_solver import OverlapConfig
from ..parallel.dispatch import PaddedDispatch
from ..parallel.dispatch import dispatch as _dispatch_op
from ..parallel.dispatch import (
    padded_dispatch_indices,
    padded_position_ids,
    padded_undispatch_indices,
)
from ..parallel.dispatch import position_ids as _position_ids
from ..parallel.dispatch import roll as _roll_op
from ..parallel.dispatch import undispatch as _undispatch_op
from ..parallel.dist_attn import (
    DistAttnPlan,
    build_dist_attn_plan,
    dist_attn_local,
    make_attn_params,
)
from ..parallel.qo_comm import QoCommPlan, build_qo_comm_plan, qo_comm_attn_local
from ..resilience import guards
from ..telemetry import numerics
from .functools import compute_pad_size, pad_at_dim

GeneralAttnMaskType = str | AttnMaskType | Sequence[str | AttnMaskType]


def _one_mask_type(t) -> int:
    if isinstance(t, str):
        name = t.strip().upper().replace("-", "_")
        name = {"INV_CAUSAL": "INVCAUSAL", "BI_CAUSAL": "BICAUSAL"}.get(name, name)
        return int(AttnMaskType[name])
    return int(t)


def _coerce_mask_types(attn_type_map, n_slices: int) -> tuple:
    """Every mask-type spelling the JAX API takes; a scalar broadcasts to
    all slices."""
    if isinstance(attn_type_map, (str, int, AttnMaskType)):
        return (int(_one_mask_type(attn_type_map)),) * n_slices
    return tuple(_one_mask_type(t) for t in attn_type_map)


def _coerce_mask(q_ranges, k_ranges, attn_type_map, *,
                 merge: bool = True) -> tuple[AttnRanges, AttnRanges, tuple]:
    """(q_ranges, k_ranges, types) of a key's mask in any spelling the JAX
    API takes; with ``merge``, merged under
    ``MAGI_ATTENTION_AUTO_RANGE_MERGE`` (as JAX's flex and cross keys do;
    its new-mask keys do not); then checked for overlapping slices under
    ``MAGI_ATTENTION_SANITY_CHECK``."""
    if not isinstance(q_ranges, AttnRanges):
        q_ranges = AttnRanges.from_ranges(q_ranges)
    if not isinstance(k_ranges, AttnRanges):
        k_ranges = AttnRanges.from_ranges(k_ranges)
    types = _coerce_mask_types(attn_type_map, len(q_ranges))
    if merge and env.is_auto_range_merge_enable():
        from ..ops.range_merge import merge_ranges

        qa, ka, ta = merge_ranges(np.asarray(q_ranges.to_naive_ranges(), np.int64),
                                  np.asarray(k_ranges.to_naive_ranges(), np.int64),
                                  np.asarray(types, np.int64))
        q_ranges = AttnRanges.from_ranges([tuple(r) for r in qa.tolist()])
        k_ranges = AttnRanges.from_ranges([tuple(r) for r in ka.tolist()])
        types = tuple(int(t) for t in ta)
    if env.is_sanity_check_enabled():
        from ..common.sanity import check_slices_non_overlapping

        check_slices_non_overlapping(q_ranges, k_ranges, types)
    return q_ranges, k_ranges, types


def _default_chunk_size(total: int, cp_size: int) -> int:
    return max(total // (env.min_chunks_per_rank() * cp_size), 128)


def flags_fingerprint() -> tuple:
    """The flags that change a plan or a kernel call, folded into the key."""
    return (
        env.kernel_backend(),
        env.block_q(),
        env.block_k(),
        env.head_block_override(),
        env.overlap_degree_default(),
        env.min_stage_rows(),
        env.dynamic_max_degree(),
        env.is_forward_high_precision_reduce(),
        env.is_backward_high_precision_reduce(),
        env.group_coll_impl(),
        env.comm_pad_to(),
        env.is_auto_range_merge_enable(),
        env.is_qo_comm_enable(),
        env.is_hierarchical_comm_enable(),
        env.is_sanity_check_enabled(),
        env.plan_reuse_mode(),
        env.unified_tick_mode(),
        # keyed as in the JAX package (MAGI_ATTENTION_VALIDATE builds nothing)
        env.guard_mode(),
        env.chaos_spec(),
        env.numerics_mode(),
    )


def check_flag_comb(*, cp_group=None, uneven_shard: bool = False, xattn: bool = False) -> None:
    """Refuse the flags and flag combinations the port does not run, with
    a ``ValueError`` that says why, before any planning: the JAX package's
    ``check_flag_comb`` for the cp layout (``cp_group`` a
    :class:`~..comm.hier.HierCpGroups`: hierarchical, the JAX ``cp_axis``
    pair), qo-comm and cross-attention (``xattn``), a kernel backend that
    is not one of ``env.KERNEL_BACKENDS`` (a JAX name included), a guard or
    chaos or numerics value outside its domain, and the validate flag the
    port does not honour yet (``env.refuse_unhonoured_flags``)."""
    env.kernel_backend()  # raises on an unknown or JAX backend name
    env.refuse_unhonoured_flags("check_flag_comb")
    qo = env.is_qo_comm_enable()
    hier_flag = env.is_hierarchical_comm_enable()
    hier_groups = len(cp_axis_names(cp_group)) == 2
    if hier_flag and not hier_groups:
        raise ValueError("MAGI_ATTENTION_HIERARCHICAL_COMM=1 requires a two-level cp group: "
                         "hierarchical comm is selected by the groups, so pass "
                         "comm.make_hier_cp_groups(cp_group, n_inter, n_intra) as cp_group")
    if qo and hier_groups:
        raise ValueError("qo-comm cannot be combined with hierarchical comm "
                         "(MAGI_ATTENTION_QO_COMM x a HierCpGroups cp_group)")
    if qo and uneven_shard:
        raise ValueError("qo-comm requires an even shard (uneven_shard=False): the dynamic "
                         "plane partition is built over equal per-rank token shards")
    if xattn and (qo or hier_groups or uneven_shard):
        raise ValueError("cross-attention keys support the flat group-cast runtime only: "
                         "qo-comm, hierarchical cp groups and uneven_shard are all "
                         "self-attention features")


@dataclasses.dataclass(frozen=True)
class DistAttnRuntimeKey:
    """Frozen hash key for one planned runtime on one rank."""

    q_ranges: tuple[tuple[int, int], ...]
    k_ranges: tuple[tuple[int, int], ...]
    attn_type_map: tuple[int, ...]
    total_seqlen_q: int  # padded
    total_seqlen_k: int
    pad_size: int
    chunk_size: int
    cp_size: int
    cp_rank: int
    group_id: int  # id() of the process group (groups are not hashable by value)
    num_heads_q: int
    num_heads_kv: int
    head_dim: int
    softcap: float
    has_sink: bool
    sink_fingerprint: int  # hash of the sink values (0 when no sink)
    out_dtype: str
    dispatch_config_repr: str
    device: str
    flags: tuple
    block_config: tuple[int, int, int]  # (block_q, block_k, head_block)
    # (n_inter, n_intra) of a hierarchical key, None for a flat one: a flat
    # and a hierarchical key on the same ranks never share a runtime
    hier: tuple[int, int] | None = None
    # the (q_ranges, k_ranges, attn_type_map) whose dispatch a new-mask key
    # inherits, None for a key with its own dispatch: a key for mask W on
    # mask A's dispatch never shares a runtime with W's own key, nor with W's
    # key on the dispatch of another mask
    dispatch_of: tuple | None = None


@dataclasses.dataclass(frozen=True)
class XAttnArgs:
    """What a cross-attention module needs about a planned key: the padded
    totals, the per-rank shard lengths, and the global positions of this
    rank's dispatched query and memory slots (int64 on the key's device)."""

    total_seqlen_q: int  # padded q length
    total_seqlen_k: int  # padded kv length
    shard_q_len: int  # per-rank q rows
    shard_k_len: int  # per-rank kv rows
    q_position_ids: torch.Tensor  # [shard_q_len]
    k_position_ids: torch.Tensor  # [shard_k_len]


class DistAttnRuntimeMgr:
    """Everything planned for one key on this rank: the dispatch meta (and
    the memory side's, for a cross-attention key), the plan (a K/V-comm
    ``DistAttnPlan``, flat or hierarchical, or a ``QoCommPlan`` under
    ``MAGI_ATTENTION_QO_COMM``), the kernels' parameters and the sink.
    ``cp_group`` is the group the key was made with (a flat group or a
    ``HierCpGroups``), ``group`` the flat group of its ranks."""

    def __init__(self, key: DistAttnRuntimeKey, cp_group, dispatch_meta: DispatchMeta,
                 plan: DistAttnPlan | QoCommPlan, params, sink: torch.Tensor | None,
                 dist_attn_config: DistAttnConfig, kv_dispatch_meta: DispatchMeta | None = None,
                 pad_size_k: int = 0):
        self.key = key
        self.cp_group = cp_group
        self.group = split_cp_group(cp_group)[0]
        self.dispatch_meta = dispatch_meta
        self.kv_dispatch_meta = kv_dispatch_meta  # cross-attention only
        self.pad_size_k = pad_size_k
        self.plan = plan
        self.params = params
        self.sink = sink
        self.dist_attn_config = dist_attn_config

    @property
    def is_cross_attn(self) -> bool:
        return self.kv_dispatch_meta is not None

    def dispatch(self, x: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
        """Global natural-order [total, ...] -> this rank's shard (padded to
        the chunk multiple first)."""
        if self.key.pad_size:
            x = pad_at_dim(x, 0, self.key.pad_size, pad_value)
        return _dispatch_op(x, self.dispatch_meta, self.group, pad_value)

    def undispatch(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's shard -> the global natural order (pad rows dropped),
        on every rank."""
        out = _undispatch_op(y, self.dispatch_meta, self.group)
        if self.key.pad_size:
            out = out[: self.key.total_seqlen_q - self.key.pad_size]
        return out

    def get_position_ids(self) -> torch.Tensor:
        """Global position of each of this rank's dispatched slots
        [shard_seqlen] int64 on the key's device (RoPE reads them)."""
        ids = _position_ids(self.dispatch_meta, self.key.cp_rank)
        return torch.from_numpy(ids.astype(np.int64)).to(self.key.device)

    def _need_cross(self, what: str) -> None:
        if not self.is_cross_attn:
            raise ValueError(f"{what} needs a cross-attn key (magi_attn_cross_key)")

    def dispatch_kv(self, x: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
        """Cross-attention: global natural-order memory [total_k, ...] ->
        this rank's memory shard, the layout ``calc_attn``'s k / v take."""
        self._need_cross("dispatch_kv")
        if self.pad_size_k:
            x = pad_at_dim(x, 0, self.pad_size_k, pad_value)
        return _dispatch_op(x, self.kv_dispatch_meta, self.group, pad_value)

    def undispatch_kv(self, y: torch.Tensor) -> torch.Tensor:
        """Cross-attention: this rank's memory shard -> the global natural
        order (pad rows dropped), on every rank."""
        self._need_cross("undispatch_kv")
        out = _undispatch_op(y, self.kv_dispatch_meta, self.group)
        if self.pad_size_k:
            out = out[: self.key.total_seqlen_k - self.pad_size_k]
        return out

    def get_xattn_args(self) -> XAttnArgs:
        """The cross-attention call arguments of this key."""
        self._need_cross("get_xattn_args")
        rank, dev = self.key.cp_rank, self.key.device

        def ids(meta):
            return torch.from_numpy(_position_ids(meta, rank).astype(np.int64)).to(dev)

        return XAttnArgs(
            total_seqlen_q=self.key.total_seqlen_q, total_seqlen_k=self.key.total_seqlen_k,
            shard_q_len=self.dispatch_meta.shard_seqlen,
            shard_k_len=self.kv_dispatch_meta.shard_seqlen,
            q_position_ids=ids(self.dispatch_meta), k_position_ids=ids(self.kv_dispatch_meta),
        )

    def calc_attn(self, q, k, v, sink=None):
        """Distributed flex attention on this rank's dispatched shards (q
        [shard, hq, d], k/v [shard, hk, d]). Returns ``(out,
        AttnForwardMeta(lse, max_logits))`` in the same layout;
        ``max_logits`` [hq] is max-reduced over the group (None on a
        qo-comm plan, as in the JAX package). ``sink`` overrides the key's
        sink (a trainable sink gets its gradient). With
        ``MAGI_ATTENTION_GUARD`` on, the plan's partials are guarded and this
        rank's error code is read here: ``check`` raises
        ``NumericalGuardError`` naming the tripped sites on the rank that
        saw them. Under ``MAGI_ATTENTION_NUMERICS=census`` every rank's value
        census is gathered over the group and read here (layer
        ``parallel``)."""
        import torch.distributed as dist

        from ..comm.primitives import replicated

        s = self.sink if sink is None else sink
        if (s is None) != (self.sink is None):
            raise ValueError("a sink override needs a key made with a sink")
        if s is not None and s.requires_grad:
            s = replicated(s, self.group)  # every rank's rows add to its gradient
        if isinstance(self.plan, QoCommPlan):
            out, lse = qo_comm_attn_local(q, k, v, self.plan, self.params, self.group, sink=s)
            return out, AttnForwardMeta(lse=lse, max_logits=None)
        thread_code = guards.guards_active()
        thread_census = numerics.census_active()
        res = dist_attn_local(q, k, v, self.plan, self.params, self.cp_group, sink=s,
                              with_guard_code=thread_code, with_census=thread_census)
        out, lse, mx = res[:3]
        mx = mx.detach().clone()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=self.group)
        if thread_census:
            # every rank's census, gathered before the guard can raise on one
            # rank, read to the host once and reduced as the JAX package's
            census = res[-1]
            every = [torch.empty_like(census) for _ in range(dist.get_world_size(self.group))]
            dist.all_gather(every, census, group=self.group)
            numerics.consume_census(torch.stack(every), numerics.census_keys(
                guards.plan_guard_sites(self.plan)), layer="parallel")
        if thread_code:
            # the call boundary of the guards, after this call's last
            # collective: this rank's code, read once (check raises
            # NumericalGuardError naming the plan's sites)
            guards.consume_error_code(res[3], guards.plan_guard_sites(self.plan))
        return out, AttnForwardMeta(lse=lse, max_logits=mx)


class BucketedDistAttnRuntimeMgr(DistAttnRuntimeMgr):
    """A runtime that serves a request's mask off a canonical
    (bucket-padded) plan: the canonical manager's dispatch meta, plan,
    kernel parameters and sink, with no solver work. Only the three
    data-movement surfaces differ, each through a table built on the host
    once from the canonical dispatch meta and the row maps
    (``parallel/dispatch.py``'s padded-index adapters, held on the key's
    device by :class:`~..parallel.dispatch.PaddedDispatch`):

    - ``dispatch(x)``: this rank's slice of the dispatch gather, taken from
      the REAL (unpadded) ``x`` [real_total, ...]; every pad slot (bucket
      pad, chunk pad, uneven-shard pad) takes ``pad_value``. Its backward
      brings every real row its cotangent and drops the pad rows';
    - ``undispatch(y)``: the all-gather of the canonical shards, then a
      gather of the real rows [real_total, ...];
    - ``get_position_ids()``: this rank's slice of the real positions (pad
      slots 0).

    The dispatched shapes are the canonical ones (at least the request's
    padded total): size buffers off ``dispatch``'s output, not the key.
    ``roll`` and the new-mask keys refuse a bucketed key: both reason in
    request coordinates, which the bucketed layout does not keep. The host
    tables stay on the manager (``_bucket_*_idx``, int32, as the JAX
    package's) for inspection."""

    def __init__(self, key: DistAttnRuntimeKey, canonical_mgr: DistAttnRuntimeMgr,
                 dispatch_idx: np.ndarray, undispatch_idx: np.ndarray,
                 position_ids: np.ndarray):
        super().__init__(key, canonical_mgr.cp_group, canonical_mgr.dispatch_meta,
                         canonical_mgr.plan, canonical_mgr.params, canonical_mgr.sink,
                         canonical_mgr.dist_attn_config)
        self.canonical_key = canonical_mgr.key
        self._bucket_dispatch_idx = np.asarray(dispatch_idx, np.int32)
        self._bucket_undispatch_idx = np.asarray(undispatch_idx, np.int32)
        self._bucket_position_ids = np.asarray(position_ids, np.int32)
        self.tables = PaddedDispatch(
            self._bucket_dispatch_idx, self._bucket_undispatch_idx, self._bucket_position_ids,
            key.total_seqlen_q - key.pad_size, canonical_mgr.dispatch_meta.shard_seqlen,
            key.cp_rank, key.device)

    def dispatch(self, x: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
        return self.tables.dispatch(x, self.group, pad_value)

    def undispatch(self, y: torch.Tensor) -> torch.Tensor:
        return self.tables.undispatch(y, self.group)

    def get_position_ids(self) -> torch.Tensor:
        return self.tables.position_ids


class DistAttnRuntimeDict:
    """LRU key -> runtime manager cache."""

    def __init__(self, maxsize: int | None = None):
        self.maxsize = env.runtime_dict_size() if maxsize is None else maxsize
        self._d: OrderedDict[DistAttnRuntimeKey, DistAttnRuntimeMgr] = OrderedDict()

    def get(self, key, default=None) -> Optional[DistAttnRuntimeMgr]:
        mgr = self._d.get(key)
        if mgr is None:
            return default
        self._d.move_to_end(key)
        return mgr

    def put(self, key, mgr) -> None:
        self._d[key] = mgr
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            telemetry.record_plan_cache_eviction(cache="runtime")

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self, group_id: Optional[int] = None) -> None:
        """Drop every entry, or those planned over one group
        (``DistAttnRuntimeKey.group_id``)."""
        if group_id is None:
            self._d.clear()
            return
        for k in [k for k in self._d if k.group_id == group_id]:
            del self._d[k]


_runtime_dict = DistAttnRuntimeDict()
_most_recent_key: Optional[DistAttnRuntimeKey] = None
# the second level of fingerprint-bucketed plan reuse, consulted between an
# exact-key miss and the cold solver: PlanFingerprint -> the canonical key
# whose runtime serves every mask of the bucket
_plan_reuse_cache = PlanReuseCache()
# set while a canonical mask is being planned: the nested key call must not
# look the fingerprint up again
_in_canonical_resolve = False


def get_runtime_mgr(key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr:
    mgr = _runtime_dict.get(key)
    if mgr is None:
        raise KeyError(f"no runtime planned for this key (cache evicted?): {key}")
    return mgr


def get_most_recent_key() -> DistAttnRuntimeKey:
    """The key most recently created (for modules that cannot thread it)."""
    if _most_recent_key is None:
        raise RuntimeError("no key has been created yet")
    return _most_recent_key


def clear_cache(cp_group=None) -> None:
    """Drop the planned runtimes and the plan-reuse cache: all of them, or
    only those planned over ``cp_group`` (a flat group or a
    ``HierCpGroups``). The most recent key is forgotten when it goes. A
    key stays valid to plan again."""
    global _most_recent_key
    if cp_group is None:
        _runtime_dict.clear()
        _plan_reuse_cache.clear()
        _most_recent_key = None
        return
    gid = id(split_cp_group(cp_group)[0])
    _runtime_dict.clear(group_id=gid)
    _plan_reuse_cache.clear(group_id=gid)
    if _most_recent_key is not None and _most_recent_key.group_id == gid:
        _most_recent_key = None


def _resolve_device(device) -> torch.device:
    """The key's device: the card by default (raises without one), or the
    CPU when asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "context-parallel attention on device='cuda': no CUDA device is "
                "available; pass device='cpu' to run the kernels' plain versions"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"device {device}: the port runs on cuda or cpu")
    return device


def _resolve_overlap_config(oc: OverlapConfig | None) -> OverlapConfig:
    """None -> the env's defaults. With degree=None (auto), the JAX package
    prices stages with TPU cost factors; until H100 factors are measured,
    the port keeps the solver-relative factors (1.0 / 1.0), which rank the
    candidate degrees by mask area and rows alone."""
    if oc is None:
        oc = OverlapConfig(
            degree=env.overlap_degree_default(),
            min_stage_rows=env.min_stage_rows(),
            dynamic_max_degree=env.dynamic_max_degree(),
        )
    return oc


def resolve_blocking(hq: int, hk: int, head_dim: int) -> tuple[int, int, int]:
    """(block_q, block_k, head_block) of a keyed runtime: the kernels' tile
    (``ops.flex_attn.resolve_tile``: the env's pin, else ``HOPPER_TILES``)
    and head_block G on the row-major grid (``flex_fwd_hb`` at G > 1), or
    ``MAGI_ATTENTION_HEAD_BLOCK`` snapped to the GQA geometry."""
    from ..ops.flex_attn import _auto_head_block, resolve_tile

    bq, bk = resolve_tile(head_dim, None, None)
    group = max(hq // max(hk, 1), 1)
    hb_env = env.head_block_override()
    return bq, bk, group if hb_env is None else _auto_head_block(hb_env, hq, group)


def key_dtype(key: DistAttnRuntimeKey) -> torch.dtype:
    """The torch dtype a key's ``out_dtype`` names."""
    return getattr(torch, key.out_dtype.split(".")[-1])


def _record_runtime_costs(plan: DistAttnPlan, key: DistAttnRuntimeKey) -> None:
    """``telemetry.record_runtime_costs`` for a key's new plan, priced on
    the card the key's device lies on (``utils/cost.py``; a CPU key records
    its bytes and FLOPs only)."""
    if not telemetry.enabled():
        return
    dev = torch.device(key.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    telemetry.record_runtime_costs(
        plan, num_heads_q=key.num_heads_q, num_heads_kv=key.num_heads_kv, head_dim=key.head_dim,
        bytes_per_elt=torch.empty((), dtype=key_dtype(key)).element_size(), card=card)


def _make_bucketed_mgr(key: DistAttnRuntimeKey, canonical_mgr: DistAttnRuntimeMgr,
                       maps) -> BucketedDistAttnRuntimeMgr:
    """The request -> canonical adapter runtime: its three tables composed
    on the host from the canonical dispatch meta and the row maps."""
    meta = canonical_mgr.dispatch_meta
    real_total = key.total_seqlen_q - key.pad_size
    return BucketedDistAttnRuntimeMgr(
        key, canonical_mgr,
        padded_dispatch_indices(meta, maps.canon_to_real, real_total),
        padded_undispatch_indices(meta, maps.real_to_canon),
        padded_position_ids(meta, maps.canon_to_real))


def _try_plan_reuse(key: DistAttnRuntimeKey, t_lookup: float, *, cp_group, sink, out_dtype,
                    dispatch_config, dist_attn_config, device) -> bool:
    """The fingerprint-bucketed second-level lookup, after an exact-key
    miss (exact hits never come here). Installs a bucketed runtime under
    ``key`` and returns True, either over a live canonical plan (a bucket
    hit: no solver work; the row maps rebuilt, or on a tail extend of the
    bucket's last request patched in O(delta)) or after planning the
    canonical mask once (a fingerprint miss: one solve then serves the
    whole bucket). Returns False when reuse is off or does not apply, as in
    the JAX package: under qo-comm (its plane partition is exact to the
    mask: no static table to adapt onto), and for a mask that
    canonicalises to itself or not at all; the caller then plans
    ``key`` itself. ``t_lookup``: when the exact-key lookup began (a
    bucket hit's solver seconds run from it)."""
    global _in_canonical_resolve
    if _in_canonical_resolve or env.plan_reuse_mode() != "bucket":
        return False
    if env.is_qo_comm_enable():
        return False
    real_total = key.total_seqlen_q - key.pad_size
    canon = canonicalize_mask(key.q_ranges, key.k_ranges, key.attn_type_map, real_total)
    if canon is None:
        return False
    new_sig = (key.q_ranges, key.k_ranges, key.attn_type_map, real_total)
    fp = make_plan_fingerprint(
        canon, chunk_size=key.chunk_size, cp_size=key.cp_size, hier=key.hier,
        num_heads_q=key.num_heads_q, num_heads_kv=key.num_heads_kv, head_dim=key.head_dim,
        softcap=key.softcap, has_sink=key.has_sink, sink_fingerprint=key.sink_fingerprint,
        out_dtype=key.out_dtype, dispatch_config_repr=key.dispatch_config_repr,
        device=key.device, block_config=key.block_config, group_id=key.group_id,
        flags=key.flags)
    entry = _plan_reuse_cache.get(fp)
    canonical_mgr = _runtime_dict.get(entry.canonical_key) if entry is not None else None
    if canonical_mgr is not None:  # a bucket hit: the canonical plan is live
        maps = None
        if entry.last_sig is not None and entry.last_maps is not None:
            if try_incremental_update(entry.last_sig, new_sig, entry.last_maps):
                maps = entry.last_maps
                telemetry.record_plan_incremental(patched=True)
            else:
                telemetry.record_plan_incremental(patched=False)
        if maps is None:
            maps = canon.build_row_maps()
        _runtime_dict.put(key, _make_bucketed_mgr(key, canonical_mgr, maps))
        entry.last_sig, entry.last_maps = new_sig, maps
        telemetry.record_cache_access(hit=True)
        telemetry.record_plan_solver(time.perf_counter() - t_lookup, cache_hit=True)
        telemetry.record_plan_bucket(hit=True)
        return True
    # a fingerprint miss (or the canonical runtime was evicted): plan the
    # canonical mask once, then adapt this request onto it
    telemetry.record_cache_access(hit=False)
    telemetry.record_plan_bucket(hit=False)
    _in_canonical_resolve = True
    try:
        canonical_key = magi_attn_flex_key(
            canon.q_ranges, canon.k_ranges, canon.attn_type_map, canon.total_seqlen,
            canon.total_seqlen, cp_group, num_heads=(key.num_heads_q, key.num_heads_kv),
            head_dim=key.head_dim, chunk_size=key.chunk_size, softcap=key.softcap,
            has_sink=key.has_sink, sink=sink, out_dtype=out_dtype,
            dispatch_config=dispatch_config, dist_attn_config=dist_attn_config, device=device)
    finally:
        _in_canonical_resolve = False
    maps = canon.build_row_maps()
    _runtime_dict.put(key, _make_bucketed_mgr(key, get_runtime_mgr(canonical_key), maps))
    _plan_reuse_cache.put(fp, ReuseEntry(canonical_key, new_sig, maps))
    return True


def magi_attn_flex_key(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_type_map: GeneralAttnMaskType,
    total_seqlen_q: int,
    total_seqlen_k: int,
    cp_group,
    *,
    num_heads: tuple[int, int],  # (hq, hkv)
    head_dim: int,
    chunk_size: int | None = None,
    softcap: float = 0.0,
    has_sink: bool = False,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
    dispatch_config: DispatchConfig | None = None,
    dist_attn_config: DistAttnConfig | None = None,
    device=None,
) -> DistAttnRuntimeKey:
    """Plan (or fetch from the cache) this rank's distributed
    flex-attention runtime for a self-attention mask of (q_range, k_range,
    mask_type) slices over ``cp_group``.

    The sequence is padded so that chunks divide evenly over the ranks. The
    overlap degree comes from ``dist_attn_config.overlap_config``, else
    ``MAGI_ATTENTION_OVERLAP_DEGREE`` (default 0: one merged cast and one
    kernel call). Under ``MAGI_ATTENTION_QO_COMM`` the plan is qo-comm's
    (the dispatch meta's ownership, the key's tile, one kernel call, no
    overlap stages). A ``HierCpGroups`` ``cp_group`` plans hierarchical
    two-level comm over its (n_inter, n_intra) layout. Under
    ``MAGI_ATTENTION_PLAN_REUSE=bucket`` an exact-key miss goes through the
    plan-reuse tier (:func:`_try_plan_reuse`) before it plans the mask
    itself. ``device`` defaults to the card."""
    import torch.distributed as dist

    global _most_recent_key
    device = _resolve_device(device)
    if total_seqlen_q != total_seqlen_k:
        raise ValueError("the self-attention interface needs equal q/k seqlens")
    hq, hkv = num_heads
    oc = _resolve_overlap_config(dist_attn_config.overlap_config if dist_attn_config else None)
    if dispatch_config is None:
        dispatch_config = dist_attn_config.dispatch_config if dist_attn_config else DispatchConfig()
    dist_attn_config = DistAttnConfig(dispatch_config=dispatch_config, overlap_config=oc)
    check_flag_comb(cp_group=cp_group, uneven_shard=dispatch_config.uneven_shard)
    q_ranges, k_ranges, types = _coerce_mask(q_ranges, k_ranges, attn_type_map)
    flat, hier = split_cp_group(cp_group)
    cp_size = dist.get_world_size(flat)
    rank = dist.get_rank(flat)
    if chunk_size is None:
        chunk_size = _default_chunk_size(total_seqlen_q, cp_size)
    pad = compute_pad_size(total_seqlen_q, 1 if dispatch_config.uneven_shard else cp_size,
                           chunk_size)
    has_sink = has_sink or sink is not None
    if has_sink and sink is None:
        raise ValueError("has_sink=True needs the sink tensor at key-creation time")
    sink_fp = hash(sink.detach().float().cpu().numpy().tobytes()) if sink is not None else 0
    block_config = resolve_blocking(hq, hkv, head_dim)
    if chunk_size % block_config[0]:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of the kernels' "
                         f"block_q {block_config[0]}")
    key = DistAttnRuntimeKey(
        q_ranges=tuple(q_ranges.to_naive_ranges()),
        k_ranges=tuple(k_ranges.to_naive_ranges()),
        attn_type_map=types,
        total_seqlen_q=total_seqlen_q + pad,
        total_seqlen_k=total_seqlen_k + pad,
        pad_size=pad,
        chunk_size=chunk_size,
        cp_size=cp_size,
        cp_rank=rank,
        group_id=id(flat),
        num_heads_q=hq,
        num_heads_kv=hkv,
        head_dim=head_dim,
        softcap=float(softcap),
        has_sink=has_sink,
        sink_fingerprint=sink_fp,
        out_dtype=str(out_dtype),
        dispatch_config_repr=repr((dispatch_config, oc)),
        device=str(device),
        flags=flags_fingerprint(),
        block_config=block_config,
        hier=hier,
    )
    t_lookup = time.perf_counter()
    if key in _runtime_dict:
        if not _in_canonical_resolve:
            # a hit's solver cost is the lookup itself
            telemetry.record_cache_access(hit=True)
            telemetry.record_plan_solver(time.perf_counter() - t_lookup, cache_hit=True)
        _most_recent_key = key
        return key
    if not _try_plan_reuse(key, t_lookup, cp_group=cp_group, sink=sink, out_dtype=out_dtype,
                           dispatch_config=dispatch_config, dist_attn_config=dist_attn_config,
                           device=device):
        if not _in_canonical_resolve:
            telemetry.record_cache_access(hit=False)
        mq, _, bucket = make_dispatch_meta_from_qk_ranges(
            q_ranges, k_ranges, [AttnMaskType(t) for t in types],
            total_seqlen_q + pad, total_seqlen_k + pad,
            chunk_size=chunk_size, cp_size=cp_size, dispatch_config=dispatch_config,
        )
        bq, bk, hb = block_config
        if env.is_qo_comm_enable():
            # the plane partition over the dispatch meta's ownership; the
            # sink is folded in after the merge, so the kernels take none
            slices = np.array([(qr.start, qr.end, kr.start, kr.end, t)
                               for qr, kr, t in zip(q_ranges, k_ranges, types)], dtype=np.int64)
            plan = build_qo_comm_plan(slices, total_seqlen_q + pad, cp_size, block_q=bq,
                                      block_k=bk, dispatch_meta=mq)
            params = make_attn_params(plan, head_dim, softcap=softcap, out_dtype=out_dtype)
        else:
            plan = build_dist_attn_plan(mq, bucket, block_q=bq, block_k=bk, overlap_config=oc,
                                        cp_mesh_shape=hier)
            _record_runtime_costs(plan, key)
            params = make_attn_params(plan, head_dim, softcap=softcap, has_sink=has_sink,
                                      out_dtype=out_dtype, head_block=hb)
        sink_t = None if sink is None else sink.detach().to(device=device, dtype=torch.float32)
        _runtime_dict.put(key, DistAttnRuntimeMgr(key, cp_group, mq, plan, params, sink_t,
                                                  dist_attn_config))
    _most_recent_key = key
    return key


def magi_attn_varlen_key(
    cu_seqlens: Sequence[int],
    total_seqlen: int,
    cp_group,
    *,
    causal: bool = True,
    window_size: tuple[int, int] = (-1, -1),
    global_window_size: int = 0,
    **kwargs,
) -> DistAttnRuntimeKey:
    """Varlen (packed-batch) convenience key over :func:`magi_attn_flex_key`;
    ``window_size=(left, right)`` applies a per-sample bidirectional sliding
    window (with ``causal=False``), optionally with ``global_window_size``
    leading keys per sample."""
    from .functools import infer_attn_mask_from_cu_seqlens

    q_ranges, k_ranges, types = infer_attn_mask_from_cu_seqlens(
        list(cu_seqlens), causal=causal, window_size=tuple(window_size),
        global_window_size=global_window_size,
    )
    return magi_attn_flex_key(q_ranges, k_ranges, types, total_seqlen, total_seqlen, cp_group,
                              **kwargs)


def magi_attn_cross_key(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_type_map: GeneralAttnMaskType,
    total_seqlen_q: int,
    total_seqlen_k: int,
    cp_group,
    *,
    num_heads: tuple[int, int],  # (hq, hkv)
    head_dim: int,
    chunk_size_q: int | None = None,
    chunk_size_k: int | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype = torch.bfloat16,
    dispatch_config: DispatchConfig | None = None,
    overlap_config: OverlapConfig | None = None,
    device=None,
) -> DistAttnRuntimeKey:
    """Plan (or fetch) this rank's CROSS-attention runtime: queries and
    memory are different sequences (``total_seqlen_q`` != ``total_seqlen_k``
    allowed; ``k_ranges`` index the memory). Queries are chunk-balanced by
    mask area, the memory gets its own sequential partition, and the group
    cast routes the remote memory rows. Each side is padded to its own
    chunk multiple over the ranks. Use the key with ``dispatch`` /
    ``dispatch_kv`` / ``calc_attn`` / ``undispatch`` (and ``undispatch_kv``,
    ``get_xattn_args``).

    No sink, qo-comm, hierarchical groups or uneven shard: those are
    self-attention features (``check_flag_comb(xattn=True)``)."""
    import torch.distributed as dist

    global _most_recent_key
    device = _resolve_device(device)
    if dispatch_config is None:
        dispatch_config = DispatchConfig()
    hq, hkv = num_heads
    overlap_config = _resolve_overlap_config(overlap_config)
    check_flag_comb(cp_group=cp_group, uneven_shard=dispatch_config.uneven_shard, xattn=True)
    q_ranges, k_ranges, types = _coerce_mask(q_ranges, k_ranges, attn_type_map)
    cp_size = dist.get_world_size(cp_group)
    rank = dist.get_rank(cp_group)
    if chunk_size_q is None:
        chunk_size_q = _default_chunk_size(total_seqlen_q, cp_size)
    if chunk_size_k is None:
        chunk_size_k = _default_chunk_size(total_seqlen_k, cp_size)
    pad_q = compute_pad_size(total_seqlen_q, cp_size, chunk_size_q)
    pad_k = compute_pad_size(total_seqlen_k, cp_size, chunk_size_k)
    block_config = resolve_blocking(hq, hkv, head_dim)
    if chunk_size_q % block_config[0]:
        raise ValueError(f"chunk_size_q {chunk_size_q} must be a multiple of the kernels' "
                         f"block_q {block_config[0]}")
    key = DistAttnRuntimeKey(
        q_ranges=tuple(q_ranges.to_naive_ranges()),
        k_ranges=tuple(k_ranges.to_naive_ranges()),
        attn_type_map=types,
        total_seqlen_q=total_seqlen_q + pad_q,
        total_seqlen_k=total_seqlen_k + pad_k,
        pad_size=pad_q,
        chunk_size=chunk_size_q,
        cp_size=cp_size,
        cp_rank=rank,
        group_id=id(cp_group),
        num_heads_q=hq,
        num_heads_kv=hkv,
        head_dim=head_dim,
        softcap=float(softcap),
        has_sink=False,
        sink_fingerprint=0,
        out_dtype=str(out_dtype),
        # pad_k keys the cache: two memory totals that pad to the same
        # multiple would otherwise share a runtime with a stale pad_size_k
        dispatch_config_repr=repr(("xattn", chunk_size_k, pad_k, dispatch_config,
                                   overlap_config)),
        device=str(device),
        flags=flags_fingerprint(),
        block_config=block_config,
    )
    t_lookup = time.perf_counter()
    if key in _runtime_dict:
        telemetry.record_cache_access(hit=True)
        telemetry.record_plan_solver(time.perf_counter() - t_lookup, cache_hit=True)
    else:
        telemetry.record_cache_access(hit=False)
        mq, mk, bucket = make_cross_attn_dispatch_meta(
            q_ranges, k_ranges, [AttnMaskType(t) for t in types],
            total_seqlen_q + pad_q, total_seqlen_k + pad_k,
            chunk_size_q=chunk_size_q, chunk_size_k=chunk_size_k, cp_size=cp_size,
            dispatch_config=dispatch_config,
        )
        bq, bk, hb = block_config
        plan = build_dist_attn_plan(mq, bucket, kv_dispatch_meta=mk, block_q=bq, block_k=bk,
                                    overlap_config=overlap_config)
        _record_runtime_costs(plan, key)
        params = make_attn_params(plan, head_dim, softcap=softcap, out_dtype=out_dtype,
                                  head_block=hb)
        _runtime_dict.put(key, DistAttnRuntimeMgr(
            key, cp_group, mq, plan, params, None,
            DistAttnConfig(dispatch_config=dispatch_config, overlap_config=overlap_config),
            kv_dispatch_meta=mk, pad_size_k=pad_k))
    _most_recent_key = key
    return key


def make_flex_key_for_new_mask_after_dispatch(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_type_map: GeneralAttnMaskType,
    old_key: DistAttnRuntimeKey,
) -> DistAttnRuntimeKey:
    """Plan a NEW self-attention mask on the EXISTING dispatch of
    ``old_key`` (hybrid layer stacks, e.g. dense causal + sliding window:
    several masks share one token permutation, so dispatched activations
    are shared and only the attention plan differs). The chunk -> rank
    partition (dispatch, undispatch, position ids) and the cp group, with
    a hierarchical key's layout, are inherited; the comm routing and the
    kernel tables are planned for the new mask.

    Refused: a key with a sink (re-key with the sink instead), a bucketed
    key (its dispatch is the canonical plan's), a qo-comm key (its plane
    partition is mask-specific) and a cross-attention key (its memory has
    a dispatch of its own). The slices are not range-merged, as in the JAX
    package."""
    global _most_recent_key
    old_mgr = get_runtime_mgr(old_key)
    if old_key.has_sink:
        raise ValueError(
            "key reuse with an attention sink is not supported: re-key with "
            f"magi_attn_flex_key(sink=...) instead (old_key has sink_fingerprint="
            f"{old_key.sink_fingerprint})")
    if isinstance(old_mgr, BucketedDistAttnRuntimeMgr):
        raise ValueError(
            "key reuse after dispatch is not supported on a bucketed (plan-reuse) key: its "
            "dispatch layout belongs to the canonical plan (canonical total="
            f"{old_mgr.dispatch_meta.total_seqlen}, request total={old_key.total_seqlen_q}), so "
            "a new mask in request coordinates cannot be planned on it — create a fresh key "
            "with magi_attn_flex_key")
    if isinstance(old_mgr.plan, QoCommPlan):
        raise ValueError(
            "key reuse is not supported for qo-comm keys: the dynamic plane partition is "
            "mask-specific, so there is no dispatch to share — create a fresh key with "
            "magi_attn_flex_key")
    if old_mgr.is_cross_attn:
        raise ValueError(
            "key reuse after dispatch plans self-attention on the query dispatch; a "
            "cross-attention key's memory has a dispatch of its own — create a fresh key "
            "with magi_attn_cross_key")
    q_ranges, k_ranges, types = _coerce_mask(q_ranges, k_ranges, attn_type_map, merge=False)
    new_key = dataclasses.replace(
        old_key,
        q_ranges=tuple(q_ranges.to_naive_ranges()),
        k_ranges=tuple(k_ranges.to_naive_ranges()),
        attn_type_map=types,
        dispatch_of=old_key.dispatch_of or (old_key.q_ranges, old_key.k_ranges,
                                            old_key.attn_type_map),
    )
    t_lookup = time.perf_counter()
    if new_key in _runtime_dict:
        telemetry.record_cache_access(hit=True)
        telemetry.record_plan_solver(time.perf_counter() - t_lookup, cache_hit=True)
    else:
        telemetry.record_cache_access(hit=False)
        meta = old_mgr.dispatch_meta
        bucket = make_global_bucket_from_qk_ranges(
            q_ranges, k_ranges, [AttnMaskType(t) for t in types], new_key.total_seqlen_q,
            meta.chunk_size)
        bq, bk, hb = new_key.block_config
        old_plan, old_params = old_mgr.plan, old_mgr.params
        plan = build_dist_attn_plan(
            meta, bucket, block_q=bq, block_k=bk,
            overlap_config=old_mgr.dist_attn_config.overlap_config,
            cp_mesh_shape=old_plan.hier)
        _record_runtime_costs(plan, new_key)
        params = make_attn_params(plan, new_key.head_dim, softcap=new_key.softcap,
                                  out_dtype=old_params.out_dtype, head_block=hb)
        _runtime_dict.put(new_key, DistAttnRuntimeMgr(
            new_key, old_mgr.cp_group, meta, plan, params, None, old_mgr.dist_attn_config))
    _most_recent_key = new_key
    return new_key


def make_varlen_key_for_new_mask_after_dispatch(
    cu_seqlens: Sequence[int],
    old_key: DistAttnRuntimeKey,
    *,
    causal: bool = True,
    window_size: tuple[int, int] = (-1, -1),
    global_window_size: int = 0,
) -> DistAttnRuntimeKey:
    """Varlen flavour of :func:`make_flex_key_for_new_mask_after_dispatch`:
    the new packed-batch mask described by ``cu_seqlens`` (``causal``,
    ``window_size`` and ``global_window_size`` as in
    :func:`magi_attn_varlen_key`) on the existing dispatch of ``old_key``."""
    from .functools import infer_attn_mask_from_cu_seqlens

    q_ranges, k_ranges, types = infer_attn_mask_from_cu_seqlens(
        list(cu_seqlens), causal=causal, window_size=tuple(window_size),
        global_window_size=global_window_size,
    )
    return make_flex_key_for_new_mask_after_dispatch(q_ranges, k_ranges, types, old_key)


def dispatch(x: torch.Tensor, key: DistAttnRuntimeKey, pad_value: float = 0.0):
    """This rank's shard of the global ``x`` [total, ...]."""
    return get_runtime_mgr(key).dispatch(x, pad_value)


def undispatch(y: torch.Tensor, key: DistAttnRuntimeKey):
    """Every rank's shard back in the global natural order, on every rank."""
    return get_runtime_mgr(key).undispatch(y)


def calc_attn(q, k, v, key: DistAttnRuntimeKey, sink=None):
    """Distributed flex attention on this rank's shards: ``(out,
    AttnForwardMeta)``."""
    return get_runtime_mgr(key).calc_attn(q, k, v, sink=sink)


def get_position_ids(key: DistAttnRuntimeKey) -> torch.Tensor:
    """Global positions of this rank's dispatched slots."""
    return get_runtime_mgr(key).get_position_ids()


def dispatch_kv(x: torch.Tensor, key: DistAttnRuntimeKey, pad_value: float = 0.0):
    """Cross-attention: this rank's shard of the global memory ``x``."""
    return get_runtime_mgr(key).dispatch_kv(x, pad_value)


def undispatch_kv(y: torch.Tensor, key: DistAttnRuntimeKey):
    """Cross-attention: every rank's memory shard back in natural order."""
    return get_runtime_mgr(key).undispatch_kv(y)


def get_xattn_args(key: DistAttnRuntimeKey) -> XAttnArgs:
    """The cross-attention call arguments of a cross key."""
    return get_runtime_mgr(key).get_xattn_args()


def roll(x: torch.Tensor, key: DistAttnRuntimeKey, shift: int, axis: int = 0) -> torch.Tensor:
    """Roll this rank's dispatched ``x`` along the global sequence by
    ``shift`` (multi-token prediction's label shift): in global order y[i]
    = x[(i - shift) mod total], over the padded total. Rows that stay on
    their rank are gathered locally; the rank-crossing rows move in one
    group cast over the key's flat group. Pad slots of an uneven shard
    keep their value. A bucketed key is refused: its dispatch is in the
    canonical plan's coordinates."""
    mgr = get_runtime_mgr(key)
    if isinstance(mgr, BucketedDistAttnRuntimeMgr):
        raise ValueError(
            "roll is not supported on a bucketed (plan-reuse) key: the shared canonical "
            f"dispatch meta describes canonical coordinates (total="
            f"{mgr.dispatch_meta.total_seqlen}), so a global roll of the request's "
            f"{key.total_seqlen_q} rows would shift through bucket-pad slots — undispatch, "
            "roll in natural order, and re-dispatch instead")
    return _roll_op(x, mgr.dispatch_meta, shift, mgr.group, axis=axis)


def roll_simple(x: torch.Tensor, key: DistAttnRuntimeKey, shift: int,
                axis: int = 0) -> torch.Tensor:
    """Alias of :func:`roll` (the reference's variant differs only in the
    order it issues its point-to-point sends)."""
    return roll(x, key, shift, axis=axis)


def magi_attn_flex_dispatch(
    x: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    total_seqlen_q: int,
    total_seqlen_k: int,
    cp_group,
    **kwargs,
) -> tuple[torch.Tensor, DistAttnRuntimeKey]:
    """Key and dispatch in one call: :func:`magi_attn_flex_key` on the mask
    (``kwargs`` as there), then this rank's shard of ``x``. Returns
    ``(local_x, key)``."""
    key = magi_attn_flex_key(q_ranges, k_ranges, attn_type_map, total_seqlen_q,
                             total_seqlen_k, cp_group, **kwargs)
    return dispatch(x, key), key


def magi_attn_varlen_dispatch(
    x: torch.Tensor,
    cu_seqlens: Sequence[int],
    total_seqlen: int,
    cp_group,
    *,
    causal: bool = True,
    **kwargs,
) -> tuple[torch.Tensor, DistAttnRuntimeKey]:
    """Key and dispatch in one call, flash-attn-varlen style:
    :func:`magi_attn_varlen_key`, then this rank's shard of ``x``."""
    key = magi_attn_varlen_key(cu_seqlens, total_seqlen, cp_group, causal=causal, **kwargs)
    return dispatch(x, key), key


def init_dist_attn_runtime_key(
    q_ranges,
    k_ranges,
    attn_mask_type,
    total_seqlen_q: int,
    total_seqlen_k: int,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int,
    chunk_size: int,
    cp_group,
    *,
    dist_attn_config: DistAttnConfig | None = None,
    **kwargs,
) -> DistAttnRuntimeKey:
    """The low-level key constructor of the reference's signature: plan a
    runtime key without the entry points' sugar. ``pad_size`` (the padding
    is resolved here) and ``cp_mesh`` (the layout comes with ``cp_group``:
    a ``HierCpGroups`` is hierarchical) are accepted and ignored; the rest
    of ``kwargs`` (``device``, ``softcap``, ``sink``, ...) goes to
    :func:`magi_attn_flex_key`."""
    for ref_only in ("pad_size", "cp_mesh"):
        kwargs.pop(ref_only, None)
    return magi_attn_flex_key(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, total_seqlen_k, cp_group,
        num_heads=(num_heads_q, num_heads_kv), head_dim=head_dim, chunk_size=chunk_size,
        dist_attn_config=dist_attn_config, **kwargs)


def init_dist_attn_runtime_mgr(
    q_ranges,
    k_ranges,
    attn_mask_type,
    total_seqlen_q: int,
    total_seqlen_k: int,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int,
    chunk_size: int,
    cp_group,
    *,
    dist_attn_config: DistAttnConfig | None = None,
    **kwargs,
) -> DistAttnRuntimeMgr:
    """The low-level manager constructor: the planned manager of
    :func:`init_dist_attn_runtime_key`'s key."""
    return get_runtime_mgr(init_dist_attn_runtime_key(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, total_seqlen_k, num_heads_q,
        num_heads_kv, head_dim, chunk_size, cp_group, dist_attn_config=dist_attn_config,
        **kwargs))


def get_telemetry_snapshot() -> dict:
    """Plain-dict snapshot of the telemetry registry: what was recorded
    while ``MAGI_ATTENTION_TELEMETRY`` (or ``telemetry.set_enabled(True)``)
    was on. Always JSON-serialisable; empty sections while telemetry is
    off."""
    return telemetry.snapshot()


def profile_attn_timeline(key: DistAttnRuntimeKey | None = None, **kwargs):
    """Measure the stage timeline of a planned runtime (default: the most
    recent key) in every rank of its group together: each stage's cast and
    kernel ms between barriers on CUDA events, the pipelined whole against
    the serial sum, and the delta against the overlap solver's timeline
    model at the card's rates. Returns a ``telemetry.MeasuredTimeline``
    (``report()``); records the ``magi_overlap_measured_*`` gauges while
    telemetry is on. Keywords go to ``telemetry.profile_key_timeline``
    (reps, inner, warmup, seed)."""
    return telemetry.profile_key_timeline(key, **kwargs)


def profile_roofline(
    key: DistAttnRuntimeKey | None = None,
    *,
    measured_tflops: float | None = None,
    measured_ms: float | None = None,
    measure: bool = False,
    workload: str | None = None,
    record: bool = True,
    **timeline_kwargs,
):
    """The mask-aware roofline of a planned runtime's workload (default:
    the most recent key): true against scheduled FLOPs at the key's
    blocking, the mask density, and the gap to the card's peak split into
    dead-step, partial-tile and masked-entry fractions. Returns a
    ``telemetry.RooflineReport`` (``report()``); records the
    ``magi_roofline_*`` gauges while telemetry is on. Pass a measurement
    (``measured_tflops`` on the mask-FLOPs convention, or ``measured_ms``),
    or ``measure=True`` to time the whole ``dist_attn_local`` through
    :func:`profile_attn_timeline` (in every rank; extra keywords go there);
    with neither, the modeled gap is attributed."""
    from ..telemetry.roofline import analyze_workload

    if key is None:
        key = get_most_recent_key()
    if measure:
        measured_ms = profile_attn_timeline(key, **timeline_kwargs).measured_total_ms
        measured_tflops = None
    bq, bk, hb = key.block_config
    dev = torch.device(key.device)
    rep = analyze_workload(
        key.q_ranges, key.k_ranges, key.attn_type_map, num_heads_q=key.num_heads_q,
        num_heads_kv=key.num_heads_kv, head_dim=key.head_dim, block_q=bq, block_k=bk,
        head_block=hb,
        bytes_per_elt=torch.empty((), dtype=key_dtype(key)).element_size(),
        device=dev,
        workload=workload if workload is not None
        else f"key_{key.total_seqlen_q}x{key.total_seqlen_k}",
        measured_tflops=measured_tflops, measured_ms=measured_ms,
        total_seqlen_q=key.total_seqlen_q, total_seqlen_k=key.total_seqlen_k)
    if record:
        telemetry.record_roofline(rep)
    return rep


def aggregate_telemetry_across_mesh(snapshot: dict | None = None, group=None) -> dict:
    """Every rank's registry snapshot gathered over ``group`` (default: the
    default group) and merged — counters summed, gauges with per-rank
    values and min/max/mean/argmax, histograms bucket-merged; a loopback
    merge of the local snapshot in one process. A collective: every rank
    of the group calls it."""
    return telemetry.aggregate_across_mesh(snapshot, group=group)
