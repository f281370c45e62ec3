"""NSA (native sparse attention) and USP-NSA baselines.

The counterpart of the JAX package's ``parallel/baselines/nsa.py``
(reference ``exps/dist_attn/baselines/nsa.py`` + ``usp_nsa.py``): the
sparse-attention baseline of the distributed benchmark. Per query, the
attention is the mean of three causal branches:

1. **cmp**: mean-pooled (compressed) K/V blocks, each visible once wholly
   in the past;
2. **slc**: the top-k full-resolution K/V blocks of each query block, per
   head, ranked by the compressed branch's scores (data-dependent);
3. **win**: a sliding window of recent tokens.

The selection depends on the data, so it cannot feed host-built tables:
the compressed and selected branches are plain tensor code (einsum, top-k,
gathers), as JAX's are plain jnp; the window branch goes through
``ops.flex_flash_attn_func`` (the flex kernels on the card). Gates are equal
weights (the benchmark baseline). USP-NSA wraps the Ulysses all-to-all
around it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...comm.group_collective import group_size

NEG_INF = float("-inf")


def _block_pool(x: torch.Tensor, block: int) -> torch.Tensor:
    """[t, h, d] -> [t / block, h, d] mean pooling."""
    t, h, d = x.shape
    return x.reshape(t // block, block, h, d).mean(dim=1)


def _dense_softmax_rows(s, v, mask):
    """Row softmax: s [..., q, n] scores, v [..., n, d], mask [..., q, n] ->
    (out [..., q, d], lse [..., q])."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe)
    el = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("...qn,...nd->...qd", p, v) / el.clamp_min(1e-30)
    lse = torch.where(el[..., 0] > 0, m_safe[..., 0] + torch.log(el[..., 0].clamp_min(1e-30)),
                      NEG_INF)
    return out, lse


@dataclasses.dataclass(frozen=True)
class NsaConfig:
    block: int = 64  # compression / selection block size
    topk: int = 8  # selected full-resolution blocks per q block
    window: int = 256  # sliding-window branch width


def nsa_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: NsaConfig = NsaConfig(), *,
             scale: float | None = None) -> torch.Tensor:
    """Single-device NSA forward, causal: (cmp + slc + win) / 3, out [t, hq,
    d] in q's dtype. GQA by repeating the K/V heads."""
    t, hq, d = q.shape
    hk = k.shape[1]
    if t % cfg.block:
        raise ValueError(f"t {t} must be a multiple of block {cfg.block}")
    group = hq // hk
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.repeat_interleave(group, dim=1)  # [t, hq, d]
    vf = v.repeat_interleave(group, dim=1)
    nb = t // cfg.block
    dev = q.device

    # cmp: pooled blocks, a block visible once wholly in the past (bi < qi);
    # scores [hq, t, nb], a 1/block share of the dense ones
    kc, vc = _block_pool(kf, cfg.block), _block_pool(vf, cfg.block)  # [nb, hq, d]
    s_cmp = torch.einsum("qhd,bhd->hqb", q, kc) * scale
    qi = torch.arange(t, device=dev)[:, None] // cfg.block
    bi = torch.arange(nb, device=dev)[None, :]
    out_cmp, _ = _dense_softmax_rows(s_cmp, vc.transpose(0, 1), (bi < qi)[None])
    out_cmp = out_cmp.transpose(0, 1)  # [t, hq, d]

    # slc: per head, the top-k blocks of each q block by the summed
    # compressed scores, attended at full resolution
    kk = min(cfg.topk, nb)
    sb = s_cmp.reshape(hq, nb, cfg.block, nb).sum(dim=2)  # [hq, qb, nb]
    ar = torch.arange(nb, device=dev)
    sb = torch.where(ar[None, None, :] <= ar[None, :, None], sb, NEG_INF)
    top_idx = torch.topk(sb.detach(), kk, dim=-1).indices  # [hq, qb, topk]
    row_idx = (top_idx[..., None] * cfg.block
               + torch.arange(cfg.block, device=dev)[None, None, None, :]
               ).reshape(hq, nb, kk * cfg.block)  # selected global rows per (h, qb)
    khm, vhm = kf.transpose(0, 1), vf.transpose(0, 1)  # [hq, t, d]
    flat = row_idx.reshape(hq, -1)[..., None].expand(-1, -1, d)
    k_sel = torch.gather(khm, 1, flat).reshape(hq, nb, kk * cfg.block, d)
    v_sel = torch.gather(vhm, 1, flat).reshape(hq, nb, kk * cfg.block, d)
    qhm = q.transpose(0, 1).reshape(hq, nb, cfg.block, d)
    s_slc = torch.einsum("hbrd,hbnd->hbrn", qhm, k_sel) * scale
    qpos = ar[:, None] * cfg.block + torch.arange(cfg.block, device=dev)[None, :]  # [qb, block]
    slc_mask = row_idx[:, :, None, :] <= qpos[None, :, :, None]
    out_slc, _ = _dense_softmax_rows(s_slc, v_sel, slc_mask)
    out_slc = out_slc.reshape(hq, t, d).transpose(0, 1)

    # win: the sliding window through the flex kernels (O(t window))
    from ...api.functools import infer_attn_mask_from_sliding_window
    from ...ops.flex_attn import flex_flash_attn_func

    swa_q, swa_k, swa_t = infer_attn_mask_from_sliding_window(t, min(cfg.window, t))
    out_win, _ = flex_flash_attn_func(q, k, v, swa_q.to_naive_ranges(), swa_k.to_naive_ranges(),
                                      [int(x) for x in swa_t], scale=scale,
                                      out_dtype=torch.float32)
    return ((out_cmp.float() + out_slc.float() + out_win) / 3.0).to(q.dtype)


def make_usp_nsa_attn_fn(total_seqlen: int, group, cfg: NsaConfig = NsaConfig()):
    """USP-NSA: ``fn(q, k, v) -> out`` on this rank's contiguous token
    shard: the Ulysses seq -> heads all-to-all, whole-sequence NSA on the
    head block, the all-to-all back (the JAX ``make_usp_nsa_attn_fn`` over
    ``P(cp)``)."""
    from ...comm.primitives import heads_to_seq, seq_to_heads
    from .ulysses import check_heads

    cp = group_size(group)

    def fn(q, k, v):
        check_heads(q.shape[1], k.shape[1], cp, "USP-NSA")
        if q.shape[0] * cp != total_seqlen:
            raise ValueError(f"{q.shape[0]} rows a rank over cp={cp} is not {total_seqlen}")
        qg, kg, vg = (seq_to_heads(x, group) for x in (q, k, v))
        return heads_to_seq(nsa_attn(qg, kg, vg, cfg), group)

    return fn
