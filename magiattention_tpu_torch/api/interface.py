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

Flags: ``MAGI_ATTENTION_QO_COMM`` plans qo-comm (``parallel/qo_comm.py``)
in place of the K/V-comm plan; ``MAGI_ATTENTION_SANITY_CHECK`` checks the
slices for overlapping coverage first; ``MAGI_ATTENTION_AUTO_RANGE_MERGE``
and ``MAGI_ATTENTION_HIERARCHICAL_COMM`` are not ported and make the key
raise (:func:`check_flag_comb`), so that no flag is taken and then
ignored. Not ported yet: cross-attention keys, the bucketed runtime
manager, plan reuse and ``roll`` (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from .. import env
from ..common.enum import AttnMaskType
from ..common.forward_meta import AttnForwardMeta
from ..common.ranges import AttnRanges
from ..config import DistAttnConfig
from ..meta.dispatch_meta import DispatchMeta, make_dispatch_meta_from_qk_ranges
from ..meta.solver.dispatch_solver import DispatchConfig
from ..meta.solver.overlap_solver import OverlapConfig
from ..parallel.dispatch import dispatch as _dispatch_op
from ..parallel.dispatch import position_ids as _position_ids
from ..parallel.dispatch import undispatch as _undispatch_op
from ..parallel.dist_attn import (
    DistAttnPlan,
    build_dist_attn_plan,
    dist_attn_local,
    make_attn_params,
)
from ..parallel.qo_comm import QoCommPlan, build_qo_comm_plan, qo_comm_attn_local
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


def flags_fingerprint() -> tuple:
    """The flags that change a plan or a kernel call, folded into the key."""
    return (
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
    )


def check_flag_comb(*, uneven_shard: bool = False) -> None:
    """Refuse the flags and flag combinations the port does not run, with
    a ``ValueError`` that says why, before any planning: the JAX package's
    ``check_flag_comb`` for qo-comm, and the flags whose JAX path is not
    ported yet."""
    qo = env.is_qo_comm_enable()
    hier = env.is_hierarchical_comm_enable()
    if env.is_auto_range_merge_enable():
        raise ValueError("MAGI_ATTENTION_AUTO_RANGE_MERGE is set, and the port has no range "
                         "merge yet (ROADMAP A.4/A.5): unset it or merge the ranges first")
    if qo and hier:
        raise ValueError("qo-comm cannot be combined with hierarchical comm "
                         "(MAGI_ATTENTION_QO_COMM x MAGI_ATTENTION_HIERARCHICAL_COMM)")
    if hier:
        raise ValueError("MAGI_ATTENTION_HIERARCHICAL_COMM is set, and the port has no "
                         "hierarchical comm yet (ROADMAP A.7/A.8): unset it")
    if qo and uneven_shard:
        raise ValueError("qo-comm requires an even shard (uneven_shard=False): the dynamic "
                         "plane partition is built over equal per-rank token shards")


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


class DistAttnRuntimeMgr:
    """Everything planned for one key on this rank: the dispatch meta, the
    plan (a K/V-comm ``DistAttnPlan``, or a ``QoCommPlan`` under
    ``MAGI_ATTENTION_QO_COMM``), the kernels' parameters and the sink."""

    def __init__(self, key: DistAttnRuntimeKey, group, dispatch_meta: DispatchMeta,
                 plan: DistAttnPlan | QoCommPlan, params, sink: torch.Tensor | None,
                 dist_attn_config: DistAttnConfig):
        self.key = key
        self.group = group
        self.dispatch_meta = dispatch_meta
        self.plan = plan
        self.params = params
        self.sink = sink
        self.dist_attn_config = dist_attn_config

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

    def calc_attn(self, q, k, v, sink=None):
        """Distributed flex attention on this rank's dispatched shards (q
        [shard, hq, d], k/v [shard, hk, d]). Returns ``(out,
        AttnForwardMeta(lse, max_logits))`` in the same layout;
        ``max_logits`` [hq] is max-reduced over the group (None on a
        qo-comm plan, as in the JAX package). ``sink`` overrides the key's
        sink (a trainable sink gets its gradient)."""
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
        out, lse, mx = dist_attn_local(q, k, v, self.plan, self.params, self.group, sink=s)
        mx = mx.detach().clone()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=self.group)
        return out, AttnForwardMeta(lse=lse, max_logits=mx)


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

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)


_runtime_dict = DistAttnRuntimeDict()
_most_recent_key: Optional[DistAttnRuntimeKey] = None


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
    overlap stages). ``device`` defaults to the card."""
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
    if not isinstance(q_ranges, AttnRanges):
        q_ranges = AttnRanges.from_ranges(q_ranges)
    if not isinstance(k_ranges, AttnRanges):
        k_ranges = AttnRanges.from_ranges(k_ranges)
    types = _coerce_mask_types(attn_type_map, len(q_ranges))
    check_flag_comb(uneven_shard=dispatch_config.uneven_shard)
    if env.is_sanity_check_enabled():
        from ..common.sanity import check_slices_non_overlapping

        check_slices_non_overlapping(q_ranges, k_ranges, types)
    cp_size = dist.get_world_size(cp_group)
    rank = dist.get_rank(cp_group)
    if chunk_size is None:
        chunk_size = max(total_seqlen_q // (env.min_chunks_per_rank() * cp_size), 128)
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
        group_id=id(cp_group),
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
    )
    if key not in _runtime_dict:
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
            plan = build_dist_attn_plan(mq, bucket, block_q=bq, block_k=bk, overlap_config=oc)
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
