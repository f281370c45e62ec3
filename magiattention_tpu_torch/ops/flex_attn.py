"""Flex-flash-attention over attention slices, forward and backward, on Hopper.

The counterpart of the JAX package's ``ops/flex_attn.py``: attention over
an arbitrary list of (q_range, k_range, mask_type) slices with GQA,
softcap, attention sink, and LSE + per-row max-logit outputs,
differentiable in q, k, v and sink. The host builds an entry table per
unique mask in both orientations (``ops/block_meta.py``); the kernels walk
it. Two grids, as in the JAX package:

- ``row_major``: ``flex_fwd`` (``csrc/flex_fwd.cu``) one q block's entries
  per thread block, or ``flex_fwd_hb`` (``csrc/flex_fwd_hb.cu``) the same
  walk for ``head_block`` q heads per block (a kv head's q heads packed in
  pairs), ``flex_dq`` (``csrc/flex_dq.cu``) the same walk for dq,
  ``flex_dkv`` (``csrc/flex_dkv.cu``) one k block's entries of the k-major
  table for dk/dv (all four warp-specialised TMA + wgmma kernels, their
  blocks launched longest walk first: :func:`walk_order`; on float32
  q/k/v the same four run the CUDA-core walks of ``csrc/flex_simt.cuh``);
- ``sparse``, the compact grid for heterogeneous masks: persistent kernels
  that take (heads, block) items from a longest-walk-first work list
  (``sparse_work``) — ``flex_fwd_sparse`` / ``flex_fwd_sparse_hb`` (the
  row-major forward walk with the AMLA base-2 softmax, one q head or
  ``head_block`` q heads per item) and ``flex_dq_sparse`` /
  ``flex_dkv_sparse`` (the row-major backward walks, persistent over their
  lists: a head pair of one kv head per dq item at even G).

:class:`_FlexAttnCore` is the ``torch.autograd.Function`` around them, the
counterpart of the JAX ``_flex_attn_core`` custom vjp, and
:func:`auto_kernel_config` picks the kernel through the autotuner
(``tuning/``) as the JAX package does.

Where it runs follows its tensors: CUDA tensors launch the kernels (or
raise) unless ``MAGI_ATTENTION_KERNEL_BACKEND`` asks for the plain
forwards (``torch``, ``torch_online``: :func:`flex_attn_headmajor`), CPU
tensors take the plain versions — :func:`_fwd_torch`, dense
attention over the mask the table encodes (the JAX ``_fwd_jnp`` with its
epilogue contract: an uncovered row gives out=0 and lse=-inf, lse=sink when
a sink is set, and rowmax excludes the sink), :func:`_fwd_torch_sparse`,
the sparse grid's entry walk with the AMLA softmax, and :func:`_dq_torch` /
:func:`_dkv_torch`, the dense backward step for step as the JAX
``_bwd_p_ds`` (both grids' backward kernels compute it). Layout inside the
kernels is head-major [heads, tokens, head_dim]; the public functions take
[tokens, heads, head_dim].
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import csrc
from .block_meta import RUN_FIELDS, SLICE_FIELDS, FlexAttnBlockMeta, build_block_meta
from .block_sparse import row_tables, work_list

NEG_INF = float("-inf")
GRID_KINDS = ("row_major", "sparse")
LOG2E = math.log2(math.e)  # the sparse grid's base-2 softmax (AMLA rescaling)
LN2 = math.log(2.0)

# Hopper tile table: head_dim -> (block_q, block_k). A first guess, not a
# tuned table: 64 query rows are the M of one wgmma (a consumer
# warpgroup's rows), and a 64-key K/V tile keeps a ring stage of K and V at
# 32 KB for d=128, so four stages and the resident tiles fit one SM (at d =
# 256 a stage is 64 KB, and the walks keep one or two: csrc/flex_fwd_sm90.cuh,
# flex_bwd_sm90.cuh). The kernels are compiled for these head dims and this
# one tile only (d = 32 rows are 64 bytes: a 64-byte TMA swizzle; d = 80 and
# 96, Phi-2's and Phi-3-mini's widths, load into d = 128's shared tile with
# zeros past d and multiply at the true d: csrc/flex_sm90.cuh). Any other
# multiple of 16 would take the same mechanism at one template instance each
# (ROADMAP.md B.13).
HOPPER_TILES: dict[int, tuple[int, int]] = {
    32: (64, 64), 64: (64, 64), 80: (64, 64), 96: (64, 64), 128: (64, 64), 256: (64, 64),
}
# The q/k/v dtypes each grid's kernels take: bf16 on the wgmma walks, and
# float32 on the CUDA-core walks (csrc/flex_simt.cuh), on either grid.
KERNEL_DTYPES: dict[str, tuple[torch.dtype, ...]] = {
    "row_major": (torch.bfloat16, torch.float32),
    "sparse": (torch.bfloat16, torch.float32),
}
# The head dims the float32 walks are built for: head_dim 256 runs in bf16
# only, float32 there is ROADMAP.md B.10.
KERNEL_F32_HEAD_DIMS = (32, 64, 80, 96, 128)

@dataclasses.dataclass(frozen=True)
class FlexAttnParams:
    """Static parameters of one flex-attention forward.

    ``head_block`` (q heads per kernel work item: 1, or a multiple of the
    GQA group that divides hq) and ``grid`` (``row_major`` or the compact
    ``sparse`` entry walk) name the JAX kernel's variants, and on the card
    pick the forward kernel as the JAX ``_fwd_dispatch`` does: ``flex_fwd``
    or ``flex_fwd_hb`` on the row-major grid, ``flex_fwd_sparse`` or
    ``flex_fwd_sparse_hb`` on the sparse one (head_block 1, or more)."""

    block_q: int
    block_k: int
    scale: float
    softcap: float
    has_sink: bool
    out_dtype: torch.dtype
    head_block: int = 1
    grid: str = "row_major"


def _device_tables(major, minor, sid, runs, bounds, num_major: int, device: str):
    rs, rc = row_tables(major, num_major)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
        for a in (major, minor, sid, runs, bounds, rs, rc)
    )


@functools.lru_cache(maxsize=256)
def fwd_tables(meta: FlexAttnBlockMeta, device: str) -> tuple[torch.Tensor, ...]:
    """The plan's forward (q-major) tables as int32 tensors on ``device``,
    copied once per (plan, device): (qblk, kblk, sid, runs, bounds, rs, rc),
    where rs/rc are the per-q-block [start, count] over the sorted entries."""
    return _device_tables(
        meta.fwd_q_block, meta.fwd_k_block, meta.fwd_slice_id, meta.fwd_runs,
        meta.slice_bounds, meta.num_q_blocks, device,
    )


@functools.lru_cache(maxsize=256)
def bwd_tables(meta: FlexAttnBlockMeta, device: str) -> tuple[torch.Tensor, ...]:
    """The k-major twin of :func:`fwd_tables` for the dk/dv walk: (kblk,
    qblk, sid, runs, bounds, rs, rc), rs/rc per k block."""
    return _device_tables(
        meta.bwd_k_block, meta.bwd_q_block, meta.bwd_slice_id, meta.bwd_runs,
        meta.slice_bounds, meta.num_k_blocks, device,
    )


class SparseWork(NamedTuple):
    """The sparse-grid kernels' work lists (``block_sparse.work_list``
    items, int32 on the device), longest walk first."""

    fwd: torch.Tensor  # (group of head_block q heads, q block)
    dq: torch.Tensor  # (group of dq_heads_per_item q heads, q block)
    dkv: torch.Tensor  # (kv head, k block), over the k-major walk


def dq_heads_per_item(hq: int, hk: int) -> int:
    """The q heads of one ``flex_dq_sparse`` item (as of one ``flex_dq``
    block): a pair of one kv head's heads where the GQA group is even, so
    that each K/V tile is loaded once for both, else one head."""
    return 2 if (hq // hk) % 2 == 0 else 1


@functools.lru_cache(maxsize=256)
def sparse_work(meta: FlexAttnBlockMeta, device: str, hq: int, hk: int,
                head_block: int) -> SparseWork:
    """The plan's work lists for ``hq``/``hk`` heads and ``head_block``,
    built on the host and copied once per (plan, device, heads,
    head_block); the dq list's items hold :func:`dq_heads_per_item` q
    heads."""
    _, rc_q = row_tables(meta.fwd_q_block, meta.num_q_blocks)
    _, rc_k = row_tables(meta.bwd_k_block, meta.num_k_blocks)

    def dev(items):
        return torch.from_numpy(items).to(device)

    return SparseWork(
        dev(work_list(rc_q, hq // head_block)),
        dev(work_list(rc_q, hq // dq_heads_per_item(hq, hk))), dev(work_list(rc_k, hk)),
    )


_BIG = 1 << 30


def _entry_tiles(tables, e: torch.Tensor, bq: int, bk: int) -> torch.Tensor:
    """[len(e), bq, bk] boolean tiles of entries ``e``: each entry's mask in
    the per-row k-interval form of the JAX package's
    ``_entry_interval_mask`` (the same predicate as ``_entry_mask``).
    ``tables`` are the (major, minor, sid, runs, bounds) tables as int64,
    either orientation; rows index the q side, columns the k side. Dummy
    entries point at the all-zero sentinel slice and mask everything."""
    qblk, kblk, sid, runs, bounds = tables[:5]
    dev = qblk.device
    n = e.shape[0]
    r = runs.view(-1, RUN_FIELDS)[e]
    b = bounds.view(-1, SLICE_FIELDS)[sid[e]]
    ql0, ql1, kl0, kl1, qoff, koff = (r[:, c : c + 1] for c in range(6))
    q0, q1, k0, k1, typ = (b[:, c : c + 1] for c in range(5))
    rl = qblk[e, None] * bq + torch.arange(bq, device=dev)[None]  # [n, bq]
    row_ok = (rl >= ql0) & (rl < ql1) & (rl + qoff >= q0) & (rl + qoff < q1)
    lo = torch.maximum(kl0, k0 - koff).expand(n, bq)
    lo = torch.where((typ & 2) == 2, torch.maximum(lo, rl + (qoff - q0 + k0 - koff)), lo)
    hi = torch.minimum(kl1, k1 - koff).expand(n, bq)
    hi = torch.where((typ & 1) == 1, torch.minimum(hi, rl + (qoff - q1 + k1 - koff + 1)), hi)
    lo = torch.where(row_ok, lo, _BIG)
    hi = torch.where(row_ok, hi, -_BIG)
    cl = kblk[e, None] * bk + torch.arange(bk, device=dev)[None]  # [n, bk]
    return (cl[:, None, :] >= lo[:, :, None]) & (cl[:, None, :] < hi[:, :, None])


def _dense_mask_from_tables(tables, tqp: int, tkp: int, bq: int, bk: int) -> torch.Tensor:
    """The [tqp, tkp] boolean mask the forward entry table describes: each
    entry's tile (:func:`_entry_tiles`), OR-ed over entries."""
    tabs = tuple(t.long() for t in tables[:5])
    qblk, kblk = tabs[:2]
    tiles = _entry_tiles(tabs, torch.arange(qblk.shape[0], device=qblk.device), bq, bk)
    nq, nk = tqp // bq, tkp // bk
    dense = torch.zeros((nq, nk, bq, bk), dtype=torch.int32, device=qblk.device)
    dense.index_put_((qblk, kblk), tiles.to(torch.int32), accumulate=True)
    return (dense > 0).permute(0, 2, 1, 3).reshape(tqp, tkp)


def _fwd_torch(q, k, v, sink, tables, params: FlexAttnParams):
    """Plain version: dense attention over the mask the entry table encodes.

    q [hq, tqp, d]; k/v [hk, tkp, d]; sink [hq] f32. Returns (out [hq, tqp,
    d] in ``params.out_dtype``, lse [hq, tqp], rowmax [hq, tqp]) in the
    kernel's contract; computes in float32 (float64 for float64 inputs).
    Differentiable by plain autograd (the maxima enter as constants, as the
    JAX ``_fwd_jnp``'s stop_gradient): the ``torch`` kernel backend runs it
    that way, and ``_FlexAttnCore`` runs it as the kernels' plain version."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    group = hq // hk
    mask = _dense_mask_from_tables(tables, tqp, tkp, params.block_q, params.block_k)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc_t).repeat_interleave(group, dim=0)  # GQA: kv head = h // group
    vf = v.to(acc_t).repeat_interleave(group, dim=0)
    z = torch.einsum("hqd,hkd->hqk", q.to(acc_t), kf) * params.scale
    if params.softcap > 0.0:
        z = params.softcap * torch.tanh(z / params.softcap)
    s = z.masked_fill(~mask[None], NEG_INF)
    del z
    m = s.amax(dim=-1).detach()  # [hq, tqp]; -inf where uncovered
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])  # masked: exp(-inf) = 0
    del s
    l = p.sum(dim=-1)
    acc = torch.einsum("hqk,hkd->hqd", p, vf)
    del p
    return _torch_epilogue(m, m_safe, l, acc, sink, params)


def _torch_epilogue(m, m_safe, l, acc, sink, params: FlexAttnParams):
    """The dense and online plain forwards' epilogue (the JAX
    ``_jnp_epilogue``): fold in the sink, give uncovered rows out=0 and
    lse=-inf (lse=sink with a sink). ``m`` is the row max of the logits
    (-inf where uncovered), ``l`` and ``acc`` are relative to ``m_safe``.
    Returns (out, lse, rowmax)."""
    if params.has_sink:
        sinkc = sink.to(acc.dtype)[:, None]  # [hq, 1]
        m_tot = torch.maximum(m, sinkc.detach())
        m_tot_safe = torch.where(torch.isneginf(m_tot), 0.0, m_tot)
        resc = torch.where(torch.isneginf(m), 0.0, torch.exp(m_safe - m_tot_safe))
        l_tot = l * resc + torch.exp(sinkc - m_tot_safe)
        acc = acc * resc[..., None]
    else:
        m_tot_safe, l_tot = m_safe, l
    covered = l_tot > 0.0
    inv = torch.where(covered, 1.0 / torch.where(covered, l_tot, 1.0), 0.0)
    out = (acc * inv[..., None]).to(params.out_dtype)
    lse = torch.where(
        covered, m_tot_safe + torch.log(torch.where(covered, l_tot, 1.0)), NEG_INF
    )
    return out, lse, m.float()


def _fwd_torch_online(q, k, v, sink, tables, params: FlexAttnParams):
    """Online-softmax plain version (the ``torch_online`` kernel backend;
    the JAX ``_fwd_jnp_online``): a loop over the k blocks of
    ``params.block_k`` keys with a running (max, sum, accumulator), GQA K/V
    kept at hk heads, each step checkpointed so that the backward recomputes
    its [hq, tqp, block_k] scores rather than keeping them. The rescale is
    built from detached maxima only, so the weight of every score telescopes
    to exp(s - m_final), as in the dense path. The block mask is still dense
    ([tqp, tkp] bool). Same contract as :func:`_fwd_torch`; differentiable
    by plain autograd."""
    from torch.utils.checkpoint import checkpoint

    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    group = hq // hk
    bk = params.block_k
    mask = _dense_mask_from_tables(tables, tqp, tkp, params.block_q, bk)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc_t).reshape(hk, group, tqp, d)
    kf, vf = k.to(acc_t), v.to(acc_t)

    def step(m, l, acc, kb, vb, mb):
        z = torch.einsum("hgqd,hkd->hgqk", qf, kb).reshape(hq, tqp, bk) * params.scale
        if params.softcap > 0.0:
            z = params.softcap * torch.tanh(z / params.softcap)
        s = z.masked_fill(~mb[None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1).detach())
        m_new_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        m_prev_safe = torch.where(torch.isneginf(m), 0.0, m)
        resc = torch.where(torch.isneginf(m), 0.0, torch.exp(m_prev_safe - m_new_safe))
        p = torch.exp(s - m_new_safe[..., None])
        pv = torch.einsum("hgqk,hkd->hgqd", p.reshape(hk, group, tqp, bk), vb)
        return m_new, l * resc + p.sum(dim=-1), acc * resc[..., None] + pv.reshape(hq, tqp, d)

    m = torch.full((hq, tqp), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((hq, tqp), dtype=acc_t, device=q.device)
    acc = torch.zeros((hq, tqp, d), dtype=acc_t, device=q.device)
    for c0 in range(0, tkp, bk):
        m, l, acc = checkpoint(step, m, l, acc, kf[:, c0:c0 + bk], vf[:, c0:c0 + bk],
                               mask[:, c0:c0 + bk], use_reentrant=False)
    # l and acc left the last step relative to its max, the global one
    return _torch_epilogue(m, torch.where(torch.isneginf(m), 0.0, m), l, acc, sink, params)


# -- the sparse grid's forward: entry walk with AMLA rescaling ----------------


def _amla_rescale(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x * 2**delta`` (delta an int32 tensor, <= 0) as an integer add on
    the exponent field, bit for bit the JAX ``_amla_rescale``: with the
    running max quantized to integers in base 2, the online softmax's
    rescale is an exact power of two. Exact for normal floats; a value
    whose exponent would leave the normal range (and every zero or
    subnormal, even at delta 0) becomes 0. The int32 add wraps as in JAX;
    the wrapped lanes are the ones ``ok`` zeroes. A float64 ``x`` (the
    plain version's oracle precision) is multiplied by ``2**delta``."""
    if x.dtype != torch.float32:
        return x * torch.exp2(delta.to(x.dtype))
    bits = x.view(torch.int32)
    wide = bits.long() + delta.long() * (1 << 23)
    wrapped = (wide + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wrap, made explicit
    shifted = wrapped.to(torch.int32).view(torch.float32)
    exp_field = (bits >> 23) & 0xFF  # the sign bit shifts out under the mask
    ok = (exp_field + delta) > 0
    return torch.where(ok, shifted, torch.zeros((), dtype=x.dtype, device=x.device))


def _amla_update(s, m_prev, l_prev, acc_prev, contract):
    """One AMLA online-softmax step (the JAX ``_amla_update``): ``s`` are
    natural-scale masked logits (-inf off the mask), reduced over their
    last axis; the running max ``m`` lives in base 2, quantized to
    integers (-inf until the row meets a live entry), so the rescale of
    ``l`` and ``acc`` is :func:`_amla_rescale`. ``contract(p)`` is P V.
    Returns ``(m_new, l_new, acc_new)``."""
    s2 = s * LOG2E
    m_cur = torch.ceil(s2.amax(dim=-1))
    m_new = torch.maximum(m_prev, m_cur)
    m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
    # fresh rows (m_prev = -inf) carry zero state: rescale by 2^0
    delta = (torch.where(m_prev == NEG_INF, m_safe, m_prev) - m_safe).to(torch.int32)
    p = torch.exp2(s2 - m_safe[..., None])
    l_new = _amla_rescale(l_prev, delta) + p.sum(dim=-1)
    acc_new = _amla_rescale(acc_prev, delta[..., None]) + contract(p)
    return m_new, l_new, acc_new


def _amla_finalize(m2, l, acc, sink, has_sink: bool):
    """The sparse forward's epilogue (the JAX ``_amla_finalize``): fold the
    base-2 quantized max back to the natural-scale reference ``mu = m2
    ln2``, fold in the optional sink (broadcastable to ``m2``), and give
    ``(out, lse)`` under the uncovered convention (out=0, lse=-inf)."""
    mu = m2 * LN2
    if has_sink:
        m_tot = torch.maximum(mu, sink)
        m_tot_safe = torch.where(m_tot == NEG_INF, 0.0, m_tot)
        resc = torch.exp(torch.where(mu == NEG_INF, NEG_INF, mu - m_tot_safe))
        l_tot = l * resc + torch.exp(sink - m_tot_safe)
        acc = acc * resc[..., None]
    else:
        m_tot_safe = torch.where(mu == NEG_INF, 0.0, mu)
        l_tot = l
    covered = l_tot > 0.0
    inv = torch.where(covered, 1.0 / torch.where(covered, l_tot, 1.0), 0.0)
    lse = torch.where(covered, m_tot_safe + torch.log(torch.where(covered, l_tot, 1.0)), NEG_INF)
    return acc * inv[..., None], lse


def _fwd_torch_sparse(q, k, v, sink, tables, params: FlexAttnParams):
    """Plain version of the sparse-grid forwards (``flex_fwd_sparse`` and
    ``flex_fwd_sparse_hb``), the TPU kernels' algorithm rather than the
    dense softmax: each q block walks its entries ``rs[i] ..
    rs[i]+rc[i]-1`` in order with the AMLA online softmax, P rounded to V's
    type before P V, the exact natural-scale row max tracked apart for
    ``rowmax``, and :func:`_amla_finalize` as the epilogue. Vectorised over
    heads and q blocks: step j takes entry ``rs[i]+j`` of every q block
    that has one. Same contract as :func:`_fwd_torch`."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    group = hq // hk
    bq, bk = params.block_q, params.block_k
    nq = tqp // bq
    dev = q.device
    acc_t = torch.promote_types(q.dtype, torch.float32)
    tabs = tuple(t.long() for t in tables[:5])
    rs, rc = tables[5].long(), tables[6].long()
    qb = q.view(hq, nq, bq, d)
    kb = k.view(hk, tkp // bk, bk, d)
    vb = v.view(hk, tkp // bk, bk, d)
    m = torch.full((hq, nq, bq), NEG_INF, dtype=acc_t, device=dev)
    mx = torch.full((hq, nq, bq), NEG_INF, dtype=acc_t, device=dev)
    l = torch.zeros((hq, nq, bq), dtype=acc_t, device=dev)
    acc = torch.zeros((hq, nq, bq, d), dtype=acc_t, device=dev)
    steps = int(rc.max()) if rc.numel() else 0
    for j in range(steps):
        blk = torch.nonzero(rc > j).squeeze(1)  # q blocks with a j-th entry
        e = rs[blk] + j
        n = blk.shape[0]
        kbj, vbj = kb[:, tabs[1][e]].to(acc_t), vb[:, tabs[1][e]]  # [hk, n, bk, d]
        qa = qb[:, blk].to(acc_t).view(hk, group, n, bq, d)
        z = torch.einsum("hgnqd,hnkd->hgnqk", qa, kbj).reshape(hq, n, bq, bk) * params.scale
        if params.softcap > 0.0:
            z = params.softcap * torch.tanh(z / params.softcap)
        s = z.masked_fill(~_entry_tiles(tabs, e, bq, bk)[None], NEG_INF)
        del z

        def contract(p):
            p = p.to(v.dtype).to(acc_t).view(hk, group, n, bq, bk)
            return torch.einsum("hgnqk,hnkd->hgnqd", p, vbj.to(acc_t)).reshape(hq, n, bq, d)

        m_new, l_new, acc_new = _amla_update(s, m[:, blk], l[:, blk], acc[:, blk], contract)
        m[:, blk], l[:, blk], acc[:, blk] = m_new, l_new, acc_new
        mx[:, blk] = torch.maximum(mx[:, blk], s.amax(dim=-1))
    sink_b = sink.to(acc_t).view(hq, 1, 1)
    out, lse = _amla_finalize(m, l, acc, sink_b, params.has_sink)
    return (
        out.reshape(hq, tqp, d).to(params.out_dtype),
        lse.reshape(hq, tqp),
        mx.reshape(hq, tqp).float(),
    )


def _check_variant(params: FlexAttnParams, hq: int, hk: int) -> None:
    """Raise on a grid or head_block that no kernel (and no plain version)
    takes: ``head_block`` is 1 or a multiple of the GQA group that divides
    hq, as the JAX launchers assert."""
    if params.grid not in GRID_KINDS:
        raise ValueError(f"grid={params.grid!r} must be one of {GRID_KINDS}")
    hb, group = params.head_block, hq // hk
    if hb < 1 or (hb > 1 and (hb % group or hq % hb)):
        raise ValueError(
            f"head_block {hb} must be 1, or a multiple of the GQA group {group} "
            f"that divides hq {hq}"
        )


def _check_kernel_args(name: str, q, k, v, params: FlexAttnParams,
                       grid: str = "row_major") -> None:
    """Raise on what the flex kernels of ``grid`` do not take: the dtype
    (:data:`KERNEL_DTYPES`), the head dim and tile, the GQA ratio."""
    hq, d, hk = q.shape[0], q.shape[2], k.shape[0]
    dtypes = KERNEL_DTYPES[grid]
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} (the {grid} grid) takes q/k/v of one dtype in {dtypes}; got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if HOPPER_TILES.get(d) != (params.block_q, params.block_k):
        raise ValueError(
            f"{name} is built for head_dim in {sorted(HOPPER_TILES)} with the "
            f"tile {HOPPER_TILES.get(d)}; got head_dim {d}, tile "
            f"({params.block_q}, {params.block_k}) (other head dims: ROADMAP.md B.13)"
        )
    if q.dtype == torch.float32 and d not in KERNEL_F32_HEAD_DIMS:
        raise TypeError(
            f"{name} takes float32 q/k/v at head_dim in {KERNEL_F32_HEAD_DIMS} only; "
            f"head_dim {d} runs in bfloat16 (float32 at head_dim 256: ROADMAP.md B.10)"
        )
    if hq % hk:
        raise ValueError(f"{name}: hq {hq} is not a multiple of hk {hk}")


def _launch_fwd(name, q, k, v, sink, tables, params: FlexAttnParams, *head_block):
    """Launch one of the row-major forwards (``head_block`` is the extra
    argument of ``flex_fwd_hb``); same contract as :func:`_fwd_torch`."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    _check_kernel_args(name, q, k, v, params)
    if params.out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"{name} writes out in {q.dtype} or float32, not {params.out_dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_tma_aligned(name, dict(q=q, k=k, v=v))
    out = torch.empty((hq, tqp, d), dtype=params.out_dtype, device=q.device)
    lse = torch.empty((hq, tqp), dtype=torch.float32, device=q.device)
    rowmax = torch.empty((hq, tqp), dtype=torch.float32, device=q.device)
    sink = sink.to(device=q.device, dtype=torch.float32).contiguous()
    _qblk, kblk, sid, runs, bounds, rs, rc = tables
    order = walk_order(rc)
    csrc.launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sink.data_ptr(),
        kblk.data_ptr(), sid.data_ptr(), runs.data_ptr(), bounds.data_ptr(),
        rs.data_ptr(), rc.data_ptr(), order.data_ptr(),
        out.data_ptr(), lse.data_ptr(), rowmax.data_ptr(),
        hq, hk, tqp, tkp, d, tqp // params.block_q, params.block_q,
        params.block_k, *head_block, float(params.scale), float(params.softcap),
        int(params.has_sink), int(params.out_dtype == torch.float32),
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse, rowmax


def _fwd_kernel(q, k, v, sink, tables, params: FlexAttnParams):
    """The ``flex_fwd`` Hopper kernel (one q head per thread block) on CUDA
    tensors, same contract as :func:`_fwd_torch`. Raises on what the kernel
    does not take."""
    return _launch_fwd("flex_fwd", q, k, v, sink, tables, params)


def _fwd_hb_kernel(q, k, v, sink, tables, params: FlexAttnParams):
    """The ``flex_fwd_hb`` Hopper kernel (``params.head_block`` q heads per
    thread block, a kv head's q heads packed two at a time) on CUDA
    tensors, same contract as :func:`_fwd_torch`: head_block does not
    change the function. Raises on what the kernel does not take."""
    _check_variant(params, q.shape[0], k.shape[0])
    return _launch_fwd("flex_fwd_hb", q, k, v, sink, tables, params, params.head_block)


def _check_work_items(name, items: torch.Tensor, groups: int, blocks: int) -> None:
    """Raise unless a work list holds one item per (head group, block)."""
    if items.numel() != groups * blocks:
        raise ValueError(f"{name}: the work list has {items.numel()} items, not one per "
                         f"({groups} head groups x {blocks} blocks)")


def _launch_fwd_sparse(name, q, k, v, sink, tables, items, heads_per_item,
                       params: FlexAttnParams):
    """Launch one of the sparse-grid forwards (persistent over ``items``, a
    work list of (group of ``heads_per_item`` q heads, q block) items);
    same contract as :func:`_fwd_torch_sparse`. Raises on what the kernel
    does not take: the dtype, head dim, tile and head_block, a work list
    that is not one item per (head group, q block), and q/k/v that TMA
    cannot load."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    _check_kernel_args(name, q, k, v, params, "sparse")
    if heads_per_item > 1:
        _check_variant(params, hq, hk)
    if params.out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"{name} writes out in {q.dtype} or float32, not {params.out_dtype}")
    _check_work_items(name, items, hq // heads_per_item, tqp // params.block_q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_tma_aligned(name, dict(q=q, k=k, v=v))
    out = torch.empty((hq, tqp, d), dtype=params.out_dtype, device=q.device)
    lse = torch.empty((hq, tqp), dtype=torch.float32, device=q.device)
    rowmax = torch.empty((hq, tqp), dtype=torch.float32, device=q.device)
    counter = torch.empty((1,), dtype=torch.int32, device=q.device)
    sink = sink.to(device=q.device, dtype=torch.float32).contiguous()
    _qblk, kblk, sid, runs, bounds, rs, rc = tables
    csrc.launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sink.data_ptr(),
        kblk.data_ptr(), sid.data_ptr(), runs.data_ptr(), bounds.data_ptr(),
        rs.data_ptr(), rc.data_ptr(), items.data_ptr(), counter.data_ptr(),
        out.data_ptr(), lse.data_ptr(), rowmax.data_ptr(),
        hq, hk, tqp, tkp, d, tqp // params.block_q, params.block_q,
        params.block_k, items.numel(), heads_per_item, float(params.scale),
        float(params.softcap), int(params.has_sink),
        int(params.out_dtype == torch.float32), int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse, rowmax


def _fwd_sparse_kernel(q, k, v, sink, tables, work: SparseWork, params: FlexAttnParams):
    """The ``flex_fwd_sparse`` Hopper kernel (one q head per work item) on
    CUDA tensors, same contract as :func:`_fwd_torch_sparse`."""
    return _launch_fwd_sparse("flex_fwd_sparse", q, k, v, sink, tables, work.fwd, 1, params)


def _fwd_sparse_hb_kernel(q, k, v, sink, tables, work: SparseWork, params: FlexAttnParams):
    """The ``flex_fwd_sparse_hb`` Hopper kernel (``head_block`` q heads per
    work item, taken a head pair of one kv head at a time where G is even)
    on CUDA tensors, same contract as :func:`_fwd_torch_sparse`."""
    return _launch_fwd_sparse("flex_fwd_sparse_hb", q, k, v, sink, tables, work.fwd,
                              params.head_block, params)


# -- backward ------------------------------------------------------------------


def _bwd_p_ds(q, k, v, do, lse, delta, mask, params: FlexAttnParams):
    """Plain backward core, the JAX ``_bwd_p_ds`` on the dense mask: p from
    the stored lse (0 where lse=-inf) and the masked logits, then ds = p (dp
    - delta_eff), times the softcap derivative 1 - (s/cap)^2 and 0 off the
    mask. Returns (p, ds [hq, tqp, tkp], kf [hq, tkp, d]) in float32
    (float64 for float64 inputs)."""
    group = q.shape[0] // k.shape[0]
    acc_t = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc_t).repeat_interleave(group, dim=0)
    vf = v.to(acc_t).repeat_interleave(group, dim=0)
    z = torch.einsum("hqd,hkd->hqk", q.to(acc_t), kf) * params.scale
    if params.softcap > 0.0:
        z = params.softcap * torch.tanh(z / params.softcap)
    s = z.masked_fill(~mask[None], NEG_INF)
    del z
    lse = lse.to(acc_t)
    lse_safe = torch.where(torch.isneginf(lse), 0.0, lse)
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.einsum("hqd,hkd->hqk", do.to(acc_t), vf)
    ds = p * (dp - delta.to(acc_t)[..., None])
    del dp
    if params.softcap > 0.0:
        ds = ds * (1.0 - (s / params.softcap) ** 2)
        ds = torch.where(torch.isneginf(s), 0.0, ds)  # nan guard off the mask
    return p, ds, kf


def _dq_torch(q, k, v, do, lse, delta, ftab, params: FlexAttnParams):
    """Plain version of ``flex_dq``: dq [hq, tqp, d] = scale ds k over the
    mask of the forward table."""
    mask = _dense_mask_from_tables(ftab, q.shape[1], k.shape[1], params.block_q, params.block_k)
    _, ds, kf = _bwd_p_ds(q, k, v, do, lse, delta, mask, params)
    return params.scale * torch.einsum("hqk,hkd->hqd", ds, kf)


def _dkv_torch(q, k, v, do, lse, delta, btab, params: FlexAttnParams):
    """Plain version of ``flex_dkv``: (dk, dv) [hk, tkp, d], summed over the
    q heads of each kv head, over the mask of the backward table."""
    kblk, qblk = btab[:2]
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    mask = _dense_mask_from_tables(
        (qblk, kblk, *btab[2:5]), tqp, tkp, params.block_q, params.block_k
    )
    p, ds, _ = _bwd_p_ds(q, k, v, do, lse, delta, mask, params)
    acc_t = p.dtype
    dv = torch.einsum("hqk,hqd->hkd", p, do.to(acc_t))
    dk = params.scale * torch.einsum("hqk,hqd->hkd", ds, q.to(acc_t))
    return (dk.view(hk, hq // hk, tkp, d).sum(1), dv.view(hk, hq // hk, tkp, d).sum(1))


def _bwd_kernel_args(name, q, k, v, do, lse, delta, params, grid="row_major"):
    _check_kernel_args(name, q, k, v, params, grid)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise TypeError(f"{name}: dout {do.dtype}{tuple(do.shape)} must match q {q.dtype}{tuple(q.shape)}")
    f32 = dict(dtype=torch.float32, device=q.device)
    return (
        q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
        lse.to(**f32).contiguous(), delta.to(**f32).contiguous(),
    )


def walk_order(rc: torch.Tensor) -> torch.Tensor:
    """The launch order of the row-major kernels' blocks: block indices by
    the length of their walk (``rc``), longest first, ties in index order
    (int32, on ``rc``'s device). The card dispatches blocks in launch
    order, so the long walks start first and the short ones fill the tail:
    on a causal mask the q blocks last to first for the forwards and dq,
    the k blocks first to last for dkv."""
    return torch.sort(rc, descending=True, stable=True).indices.to(torch.int32)


def _check_tma_aligned(name, tensors) -> None:
    """The warp-specialised kernels load q, k, v (and the backward's dout)
    through TMA tensor maps and the dk/dv walks lse / delta with bulk
    copies: each base must be 16-byte aligned (their row strides, 2 d and 4
    bytes x 64, are)."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} at {t.data_ptr():#x} is not 16-byte aligned "
                             "(TMA needs it)")


def _dq_kernel(q, k, v, do, lse, delta, ftab, params: FlexAttnParams):
    """The ``flex_dq`` Hopper kernel on CUDA tensors, same contract as
    :func:`_dq_torch` (dq in float32). Raises on what it does not take."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    q, k, v, do, lse, delta = _bwd_kernel_args("flex_dq", q, k, v, do, lse, delta, params)
    _check_tma_aligned("flex_dq", dict(q=q, k=k, v=v, dout=do))
    dq = torch.empty((hq, tqp, d), dtype=torch.float32, device=q.device)
    _qblk, kblk, sid, runs, bounds, rs, rc = ftab
    order = walk_order(rc)
    csrc.launch(
        "flex_dq",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        kblk.data_ptr(), sid.data_ptr(), runs.data_ptr(), bounds.data_ptr(),
        rs.data_ptr(), rc.data_ptr(), order.data_ptr(), dq.data_ptr(),
        hq, hk, tqp, tkp, d, tqp // params.block_q, params.block_q,
        params.block_k, float(params.scale), float(params.softcap),
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq


def _dkv_kernel(q, k, v, do, lse, delta, btab, params: FlexAttnParams):
    """The ``flex_dkv`` Hopper kernel on CUDA tensors, same contract as
    :func:`_dkv_torch` (dk, dv in float32). Raises on what it does not
    take."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    q, k, v, do, lse, delta = _bwd_kernel_args("flex_dkv", q, k, v, do, lse, delta, params)
    _check_tma_aligned("flex_dkv", dict(q=q, k=k, v=v, dout=do, lse=lse, delta=delta))
    dk = torch.empty((hk, tkp, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((hk, tkp, d), dtype=torch.float32, device=q.device)
    _kblk, qblk, sid, runs, bounds, rs, rc = btab
    order = walk_order(rc)
    csrc.launch(
        "flex_dkv",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        qblk.data_ptr(), sid.data_ptr(), runs.data_ptr(), bounds.data_ptr(),
        rs.data_ptr(), rc.data_ptr(), order.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        hq, hk, tqp, tkp, d, tkp // params.block_k, params.block_q,
        params.block_k, float(params.scale), float(params.softcap),
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dk, dv


def _dq_sparse_kernel(q, k, v, do, lse, delta, ftab, work: SparseWork,
                      params: FlexAttnParams):
    """The ``flex_dq_sparse`` Hopper kernel on CUDA tensors: ``flex_dq``'s
    walk, persistent over the (head pair or q head, q block) items of the
    work list. Same contract as :func:`_dq_torch`, and ``flex_dq``'s bits.
    Raises on what it does not take."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    q, k, v, do, lse, delta = _bwd_kernel_args("flex_dq_sparse", q, k, v, do, lse, delta,
                                               params, "sparse")
    _check_tma_aligned("flex_dq_sparse", dict(q=q, k=k, v=v, dout=do))
    _check_work_items("flex_dq_sparse", work.dq, hq // dq_heads_per_item(hq, hk),
                      tqp // params.block_q)
    dq = torch.empty((hq, tqp, d), dtype=torch.float32, device=q.device)
    counter = torch.empty((1,), dtype=torch.int32, device=q.device)
    _qblk, kblk, sid, runs, bounds, rs, rc = ftab
    csrc.launch(
        "flex_dq_sparse",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        kblk.data_ptr(), sid.data_ptr(), runs.data_ptr(), bounds.data_ptr(),
        rs.data_ptr(), rc.data_ptr(), work.dq.data_ptr(), counter.data_ptr(),
        dq.data_ptr(),
        hq, hk, tqp, tkp, d, tqp // params.block_q, params.block_q,
        params.block_k, work.dq.numel(), float(params.scale), float(params.softcap),
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq


def _dkv_sparse_kernel(q, k, v, do, lse, delta, btab, work: SparseWork,
                       params: FlexAttnParams):
    """The ``flex_dkv_sparse`` Hopper kernel on CUDA tensors: ``flex_dkv``'s
    walk, persistent over the (kv head, k block) items of the work list.
    Same contract as :func:`_dkv_torch`, and ``flex_dkv``'s bits. Raises on
    what it does not take."""
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    q, k, v, do, lse, delta = _bwd_kernel_args("flex_dkv_sparse", q, k, v, do, lse, delta,
                                               params, "sparse")
    _check_tma_aligned("flex_dkv_sparse", dict(q=q, k=k, v=v, dout=do, lse=lse, delta=delta))
    _check_work_items("flex_dkv_sparse", work.dkv, hk, tkp // params.block_k)
    dk = torch.empty((hk, tkp, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((hk, tkp, d), dtype=torch.float32, device=q.device)
    counter = torch.empty((1,), dtype=torch.int32, device=q.device)
    _kblk, qblk, sid, runs, bounds, rs, rc = btab
    csrc.launch(
        "flex_dkv_sparse",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        qblk.data_ptr(), sid.data_ptr(), runs.data_ptr(), bounds.data_ptr(),
        rs.data_ptr(), rc.data_ptr(), work.dkv.data_ptr(), counter.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        hq, hk, tqp, tkp, d, tkp // params.block_k, params.block_q,
        params.block_k, work.dkv.numel(), float(params.scale), float(params.softcap),
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dk, dv


class _FlexAttnCore(torch.autograd.Function):
    """Head-major, padded flex attention with its backward: the counterpart
    of the JAX ``_flex_attn_core`` custom vjp (``_flex_attn_core_fwd`` /
    ``_bwd``). Returns (out, lse, rowmax); rowmax is not differentiable.
    CUDA tensors run the kernels of ``params.grid`` (the forward picked by
    ``(grid, head_block)`` as the JAX ``_fwd_dispatch`` picks, the sparse
    dq/dkv whenever the grid is sparse, as JAX ``_dq_pallas`` /
    ``_dkv_pallas`` do), CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, sink1d, ftab, btab, params: FlexAttnParams, work=None):
        ctx.kernel = on_card(q, k, v)
        sparse = params.grid == "sparse"
        if not ctx.kernel:
            fwd = _fwd_torch_sparse if sparse else _fwd_torch
            out, lse, rowmax = fwd(q, k, v, sink1d, ftab, params)
        elif sparse:
            if work is None:
                raise ValueError("grid='sparse' on the card needs the plan's work lists "
                                 "(sparse_work)")
            fwd = _fwd_sparse_hb_kernel if params.head_block > 1 else _fwd_sparse_kernel
            out, lse, rowmax = fwd(q, k, v, sink1d, ftab, work, params)
        else:
            fwd = _fwd_hb_kernel if params.head_block > 1 else _fwd_kernel
            out, lse, rowmax = fwd(q, k, v, sink1d, ftab, params)
        ctx.save_for_backward(q, k, v, sink1d, out, lse)
        ctx.btab, ctx.ftab, ctx.params, ctx.work = btab, ftab, params, work
        ctx.mark_non_differentiable(rowmax)
        return out, lse, rowmax

    @staticmethod
    def backward(ctx, dout, dlse, _drowmax):
        q, k, v, sink1d, out, lse = ctx.saved_tensors
        params = ctx.params
        # The lse cotangent is first-class: with out = softmax(s) v and
        # lse = logsumexp(s), dL/ds = p (dp - (delta - dlse)), so dlse folds
        # into the delta term (an unused output's cotangent arrives as 0).
        # delta is taken from the dO the kernels read (rounded to q's dtype),
        # so that dp - delta cancels exactly where the two agree: a partial's
        # f32 cotangent (a cp stage, a qo-comm region) rounded for dp but not
        # for delta would leave its rounding error times sum_k p k in dq. The
        # JAX package takes delta from the unrounded cotangent; the two agree
        # whenever dO already has q's dtype (f32, or a bf16 loss gradient).
        do = dout.to(q.dtype).contiguous()
        acc_t = torch.promote_types(out.dtype, torch.float32)
        delta = (do.to(acc_t) * out.to(acc_t)).sum(-1) - dlse.to(acc_t)
        args = (q, k, v, do, lse, delta)
        if not ctx.kernel:
            dq = _dq_torch(*args, ctx.ftab, params)
            dk, dv = _dkv_torch(*args, ctx.btab, params)
        elif params.grid == "sparse":
            dq = _dq_sparse_kernel(*args, ctx.ftab, ctx.work, params)
            dk, dv = _dkv_sparse_kernel(*args, ctx.btab, ctx.work, params)
        else:
            dq = _dq_kernel(*args, ctx.ftab, params)
            dk, dv = _dkv_kernel(*args, ctx.btab, params)
        dsink = None
        if params.has_sink:
            # dL/dsink_h = -sum_q exp(sink_h - lse_hq) delta_eff_hq
            w = torch.where(
                torch.isneginf(lse), 0.0, torch.exp(sink1d.to(lse.dtype)[:, None] - lse)
            )
            dsink = -(w * delta.to(lse.dtype)).sum(dim=1).to(sink1d.dtype)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dsink, None, None, None, None


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (kernel path), False on
    the CPU (plain path). Raises for mixed devices and for any other device
    type: there is no third path and no fallback."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(
        f"tensors on {dev}: the port runs on cuda (its kernels) or on the "
        "cpu (their plain versions)"
    )


def flex_attn_headmajor(q, k, v, ftab, btab, params: FlexAttnParams, sink=None,
                        work: SparseWork | None = None):
    """Head-major differentiable core: q [hq, tqp, d], k/v [hk, tkp, d]
    (block-multiple padded), the plan's forward and backward tables, and
    for ``grid="sparse"`` on the card its work lists (:func:`sparse_work`);
    returns (out [hq, tqp, d], lse [hq, tqp], rowmax [hq, tqp]).
    Differentiable in q, k, v and sink (rowmax is not).

    ``MAGI_ATTENTION_KERNEL_BACKEND`` (``env.kernel_backend``) picks what
    runs, as the JAX ``flex_attn_headmajor`` does: ``cuda`` the
    :class:`_FlexAttnCore` (the kernels on CUDA tensors, their plain
    versions on CPU ones), ``torch`` / ``torch_online`` the dense /
    online plain forward (:func:`_fwd_torch` / :func:`_fwd_torch_online`)
    on the tensors' device, under plain autograd, on the same tables."""
    from .. import env

    hq = q.shape[0]
    _check_variant(params, hq, k.shape[0])
    backend = env.kernel_backend()
    acc_t = torch.promote_types(q.dtype, torch.float32)  # float64 stays float64
    if sink is not None:
        sink1d = sink.to(device=q.device, dtype=acc_t).reshape(hq)
    else:
        sink1d = torch.zeros((hq,), dtype=acc_t, device=q.device)
    if backend == "cuda":
        return _FlexAttnCore.apply(q, k, v, sink1d, ftab, btab, params, work)
    on_card(q, k, v)  # the same device checks; either device runs the plain forward
    fwd = _fwd_torch if backend == "torch" else _fwd_torch_online
    return fwd(q, k, v, sink1d, tuple(ftab), params)


def _pad_tokens(x: torch.Tensor, target: int) -> torch.Tensor:
    """Pad the token axis (dim 1) of a head-major tensor with zeros."""
    pad = target - x.shape[1]
    if pad <= 0:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def flex_attn_with_meta(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,
    meta: FlexAttnBlockMeta,
    *,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    head_block: int = 1,
    grid: str = "row_major",
    return_max_logits: bool = False,
):
    """Flex attention with a prebuilt block plan. Differentiable in q/k/v/sink.

    Transposes to head-major, pads the tokens to block multiples (the ragged
    tail is dropped after the call), and runs the kernels of ``grid`` (with
    the plan's :func:`sparse_work` lists for the sparse grid on the card)
    or the plain versions; the transposes and pads stay ordinary autograd ops around the
    core, as the JAX package keeps them outside its custom vjp. Returns
    (out [tq, hq, d], lse [tq, hq]) plus max_logits [hq] when
    ``return_max_logits`` (max_logits is not differentiable)."""
    from .. import env

    tq, hq, d = q.shape
    tk, hk, _ = k.shape
    if meta.total_q != tq or meta.total_k != tk:
        raise ValueError(
            f"meta built for ({meta.total_q},{meta.total_k}), got ({tq},{tk})"
        )
    if hq % hk:
        raise ValueError(f"hq {hq} is not a multiple of hk {hk}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    params = FlexAttnParams(
        block_q=meta.block_q,
        block_k=meta.block_k,
        scale=float(scale),
        softcap=float(softcap),
        has_sink=sink is not None,
        out_dtype=out_dtype if out_dtype is not None else q.dtype,
        head_block=int(head_block),
        grid=str(grid),
    )
    tqp = meta.num_q_blocks * meta.block_q
    tkp = meta.num_k_blocks * meta.block_k
    qh = _pad_tokens(q.transpose(0, 1), tqp)
    kh = _pad_tokens(k.transpose(0, 1), tkp)
    vh = _pad_tokens(v.transpose(0, 1), tkp)
    dev = str(q.device)
    work = None
    if params.grid == "sparse" and q.device.type == "cuda" and env.kernel_backend() == "cuda":
        work = sparse_work(meta, dev, hq, hk, params.head_block)
    out_h, lse_h, rowmax_h = flex_attn_headmajor(
        qh, kh, vh, fwd_tables(meta, dev), bwd_tables(meta, dev), params, sink=sink,
        work=work,
    )
    out = out_h.transpose(0, 1)[:tq]
    lse = lse_h.transpose(0, 1)[:tq]
    if return_max_logits:
        return out, lse, rowmax_h.amax(dim=1)
    return out, lse


@functools.lru_cache(maxsize=256)
def _cached_meta(
    q_ranges_b: bytes,
    k_ranges_b: bytes,
    types_b: bytes,
    n_slices: int,
    total_q: int,
    total_k: int,
    block_q: int,
    block_k: int,
) -> FlexAttnBlockMeta:
    return build_block_meta(
        np.frombuffer(q_ranges_b, dtype=np.int64).reshape(n_slices, 2),
        np.frombuffer(k_ranges_b, dtype=np.int64).reshape(n_slices, 2),
        np.frombuffer(types_b, dtype=np.int64),
        total_q,
        total_k,
        block_q=block_q,
        block_k=block_k,
    )


def resolve_tile(head_dim: int, block_q: int | None, block_k: int | None) -> tuple[int, int]:
    """(block_q, block_k): explicit > ``MAGI_ATTENTION_BLOCK_Q/_K`` > the
    Hopper tile table (64 x 64 for a head_dim outside it: the plain version
    takes any tile, the kernel raises)."""
    from .. import env

    tbq, tbk = HOPPER_TILES.get(int(head_dim), (64, 64))
    if block_q is None:
        block_q = env.block_q() or tbq
    if block_k is None:
        block_k = env.block_k() or tbk
    return int(block_q), int(block_k)


def _auto_head_block(pref: int, hq: int, group: int) -> int:
    """Largest head_block <= pref that divides hq and is a multiple of the
    GQA group (the group itself when none is; pref <= 1 gives 1): the JAX
    ``_auto_head_block``."""
    if pref <= 1:
        return 1
    best = group if hq % group == 0 else 1
    c = group
    while c <= min(pref, hq):
        if hq % c == 0:
            best = c
        c += group
    return best


def pin_head_block(head_block: int, hq: int, hk: int) -> int:
    """``head_block``, or ``MAGI_ATTENTION_HEAD_BLOCK`` snapped to the GQA
    geometry by :func:`_auto_head_block` where that is set: the pin every
    decision (the static rule's, the tuner's, the keyed API's, the model
    harness's) passes through."""
    from .. import env

    hb_env = env.head_block_override()
    if hb_env is None:
        return head_block
    return _auto_head_block(hb_env, hq, max(hq // max(hk, 1), 1))


def _static_block_config(q_ranges, k_ranges, hq: int, hk: int, *,
                         fixed_block_q: int | None = None, fixed_block_k: int | None = None,
                         head_dim: int = 128) -> tuple[int, int, int]:
    """The static rule (``MAGI_ATTENTION_AUTOTUNE=off`` and a caller-fixed
    tile), the counterpart of the JAX ``_static_block_config``: the tile of
    :func:`resolve_tile` (the caller's, the env's, or ``HOPPER_TILES``)
    and head_block G, or ``MAGI_ATTENTION_HEAD_BLOCK`` snapped
    (:func:`pin_head_block`). Its grid is the row-major one. The reference's
    table of TPU rungs does not carry over: the Hopper kernels have one
    tile, and a block walks its further heads in turn (head_block 2G
    measured no faster than G on the serving prefill, PERF.md §6); the
    ranges are taken for the reference's signature."""
    block_q, block_k = resolve_tile(head_dim, fixed_block_q, fixed_block_k)
    return block_q, block_k, pin_head_block(max(hq // max(hk, 1), 1), hq, hk)


def _tuned(decision, q_ranges, k_ranges, hq: int, hk: int, head_dim: int):
    """A tuner decision with the env's pins applied: the tile of
    ``MAGI_ATTENTION_BLOCK_Q/_K`` (the plain versions take any) and
    ``MAGI_ATTENTION_HEAD_BLOCK`` snapped; the static rule if the tuner had
    no candidate."""
    if decision is None:
        return (*_static_block_config(q_ranges, k_ranges, hq, hk, head_dim=head_dim),
                "row_major")
    block_q, block_k = resolve_tile(head_dim, None, None)
    return block_q, block_k, pin_head_block(decision.head_block, hq, hk), decision.grid


def auto_kernel_config(
    q_ranges,
    k_ranges,
    hq: int,
    hk: int,
    *,
    fixed_block_q: int | None = None,
    fixed_block_k: int | None = None,
    attn_type_map=None,
    head_dim: int = 128,
    dtype: str = "bfloat16",
    measure_fn=None,
    grid: str | None = None,
    device=None,
) -> tuple[int, int, int, str]:
    """(block_q, block_k, head_block, grid) for a mask on ``device`` (the
    tuning fingerprint's card; default: the card, else the CPU), the
    counterpart of the JAX ``auto_kernel_config``.

    By default the autotuner decides (``tuning.select_block_config``):
    the cost model ranks the tile, grid and head_block candidates the build
    can launch, or, under ``MAGI_ATTENTION_AUTOTUNE=measure`` with a
    ``measure_fn``, its top candidates are timed; the winner is cached by
    workload fingerprint. Inside the model's error bar the preference order
    decides: head_block G, the row-major grid on a dense mask and the
    sparse grid below ``SPARSE_DENSITY_THRESHOLD``.
    ``MAGI_ATTENTION_AUTOTUNE=off`` or a caller-fixed ``block_q`` /
    ``block_k`` take the static rule (:func:`_static_block_config`) on the
    row-major grid. ``grid`` (the caller's pin, else ``MAGI_ATTENTION_GRID``)
    pins the grid; a row-major pin also restricts the ranking to that grid
    (:func:`auto_block_config`). ``MAGI_ATTENTION_BLOCK_Q/_K`` and
    ``MAGI_ATTENTION_HEAD_BLOCK`` pin the tile and head_block of any
    decision."""
    from .. import env

    grid_pin = grid if grid is not None else env.grid_override()
    if grid_pin is not None and grid_pin not in GRID_KINDS:
        raise ValueError(f"grid={grid_pin!r} must be one of {GRID_KINDS}")
    if (grid_pin == "row_major" or fixed_block_q is not None or fixed_block_k is not None
            or env.autotune_mode() == "off"):
        # the static rule, or the row-major grid's own ranking
        return (*auto_block_config(q_ranges, k_ranges, hq, hk, fixed_block_q=fixed_block_q,
                                   fixed_block_k=fixed_block_k, attn_type_map=attn_type_map,
                                   head_dim=head_dim, dtype=dtype, measure_fn=measure_fn,
                                   device=device), grid_pin or "row_major")
    from ..tuning import select_block_config

    decision = select_block_config(q_ranges, k_ranges, attn_type_map, hq, hk, head_dim=head_dim,
                                   dtype=dtype, measure_fn=measure_fn, device=device)
    block_q, block_k, head_block, chosen = _tuned(decision, q_ranges, k_ranges, hq, hk, head_dim)
    return block_q, block_k, head_block, grid_pin or chosen


def auto_block_config(
    q_ranges,
    k_ranges,
    hq: int,
    hk: int,
    *,
    fixed_block_q: int | None = None,
    fixed_block_k: int | None = None,
    attn_type_map=None,
    head_dim: int = 128,
    dtype: str = "bfloat16",
    measure_fn=None,
    device=None,
) -> tuple[int, int, int]:
    """(block_q, block_k, head_block) for a caller that runs the row-major
    grid whatever the mask (the JAX ``auto_block_config``): the ranking is
    the row-major grid's, under a fingerprint of its own, so it never
    shares a cache entry with :func:`auto_kernel_config`'s full ranking."""
    from .. import env

    if fixed_block_q is not None or fixed_block_k is not None or env.autotune_mode() == "off":
        return _static_block_config(q_ranges, k_ranges, hq, hk, fixed_block_q=fixed_block_q,
                                    fixed_block_k=fixed_block_k, head_dim=head_dim)
    from ..tuning import select_block_config

    decision = select_block_config(q_ranges, k_ranges, attn_type_map, hq, hk, head_dim=head_dim,
                                   dtype=dtype, measure_fn=measure_fn, include_sparse=False,
                                   device=device)
    return _tuned(decision, q_ranges, k_ranges, hq, hk, head_dim)[:3]


def _make_measure_fn(q, k, v, q_arr, k_arr, t_arr, *, scale, softcap, sink, out_dtype,
                     warmup: int = 1, reps: int = 3):
    """The timer of ``MAGI_ATTENTION_AUTOTUNE=measure``: the forward at one
    candidate on the caller's own operands, without autograd, its median ms
    over ``reps`` after ``warmup`` calls (``telemetry.roofline.device_ms``:
    CUDA events with the stream held on the card, the host clock on the
    CPU), in seconds. The plan comes from :func:`_cached_meta`, so it is
    built in the warm-up, never timed, and the winner's plan is ready for
    the tuned call."""
    from ..telemetry.roofline import device_ms

    cuda = on_card(q, k, v)

    def measure(bq: int, bk: int, hb: int, grid: str = "row_major") -> float:
        meta = _cached_meta(q_arr.tobytes(), k_arr.tobytes(), t_arr.tobytes(),
                            int(t_arr.shape[0]), int(q.shape[0]), int(k.shape[0]), int(bq),
                            int(bk))

        def run():
            with torch.no_grad():
                flex_attn_with_meta(q, k, v, meta, scale=scale, softcap=softcap, sink=sink,
                                    out_dtype=out_dtype, head_block=hb, grid=grid)

        return device_ms(run, reps=reps, warmup=warmup, cuda=cuda) * 1e-3

    return measure


def flex_flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,  # [S, 2] host values (numpy / lists) — static per mask
    k_ranges,
    attn_type_map,
    *,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
    head_block: int | None = None,
    grid: str | None = None,
    return_max_logits: bool = False,
):
    """Single-device flex-flash-attention, differentiable in q/k/v/sink.

    The ranges are host values: the kernel plan is built once per unique
    (mask, shape, blocking) and cached. ``block_q``/``block_k``/
    ``head_block`` left unset resolve through :func:`auto_kernel_config`
    (the autotuner), as in the JAX package: heterogeneous masks take the
    compact sparse grid, dense ones the row-major grid, both at head_block
    G; under ``MAGI_ATTENTION_AUTOTUNE=measure``, with none of the three
    given, the tuner times its top candidates on these operands
    (:func:`_make_measure_fn`). With all
    three given, ``grid`` is the caller's, else ``MAGI_ATTENTION_GRID``,
    else ``"row_major"``, as the reference takes it. Under
    ``MAGI_ATTENTION_AUTO_RANGE_MERGE`` the slices are merged first
    (``ops/range_merge.py``)."""
    from .. import env

    q_arr = np.ascontiguousarray(np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2))
    k_arr = np.ascontiguousarray(np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2))
    t_arr = np.ascontiguousarray(np.asarray(attn_type_map, dtype=np.int64).reshape(-1))
    if env.is_auto_range_merge_enable():
        from .range_merge import merge_ranges

        q_arr, k_arr, t_arr = (np.ascontiguousarray(a) for a in merge_ranges(q_arr, k_arr, t_arr))
    q_b, k_b, t_b = q_arr.tobytes(), k_arr.tobytes(), t_arr.tobytes()
    if None in (block_q, block_k, head_block):
        from ..tuning.autotuner import memoised

        def choose():
            measure_fn = None
            if (head_block is None and block_q is None and block_k is None
                    and env.autotune_mode() == "measure" and env.head_block_override() is None
                    and env.block_q() is None and env.block_k() is None):
                # the candidates timed on these operands; a pinned head_block
                # or tile takes the model instead: the candidates would be
                # timed at their own, the call would run the pin
                measure_fn = _make_measure_fn(q, k, v, q_arr, k_arr, t_arr, scale=scale,
                                              softcap=softcap, sink=sink, out_dtype=out_dtype)
            return auto_kernel_config(
                q_arr, k_arr, int(q.shape[1]), int(k.shape[1]),
                fixed_block_q=block_q, fixed_block_k=block_k, attn_type_map=t_arr,
                head_dim=int(q.shape[2]), dtype=str(q.dtype), measure_fn=measure_fn, grid=grid,
                device=q.device,
            )

        # a repeat call (the same slices, extents, dtype, card, pins and
        # flags) takes its decision from the memo: no fingerprint
        block_q, block_k, auto_hb, grid = memoised(
            ("flex", q_b, k_b, t_b, *q.shape, *k.shape[:2], str(q.dtype), str(q.device),
             block_q, block_k, head_block, grid), choose)
        head_block = auto_hb if head_block is None else head_block
    elif grid is None:
        grid = env.grid_override() or "row_major"
    meta = _cached_meta(q_b, k_b, t_b, int(t_arr.shape[0]), int(q.shape[0]), int(k.shape[0]),
                        int(block_q), int(block_k))
    return flex_attn_with_meta(
        q,
        k,
        v,
        meta,
        scale=scale,
        softcap=softcap,
        sink=sink,
        out_dtype=out_dtype,
        head_block=head_block,
        grid=grid,
        return_max_logits=return_max_logits,
    )
