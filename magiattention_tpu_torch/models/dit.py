"""Magi-1-style video-diffusion transformer (DiT) trained with flex attention.

The counterpart of the JAX package's ``models/dit.py``: SandAI's Magi-1
denoises a video latent stream split into fixed-size time chunks, each
chunk attending to itself and to every earlier chunk and never to a later
one (:func:`chunk_causal_mask`, the ``varlen_block_causal`` family as FULL
slices over ``[0, chunk_end)``). The same configuration, parameter tree,
initialisation scheme and block:

- adaLN-zero conditioning: the diffusion-timestep embedding gives each block
  its (shift, scale, gate) for the attention and MLP branches (the final
  projections start at zero, so each block starts as the identity);
- self-attention over the video stream through flex attention (GQA, RoPE on
  flat positions);
- cross-attention to the text tokens, computed rank-locally from the
  replicated text stream with dense torch ops and no collective, as in JAX;
- an MLP with the tanh-approximated GELU (``jax.nn.gelu``'s default).

The objective is rectified-flow velocity matching: the clean latents are
noised per chunk at an independent t in [0, 1], the model predicts the
velocity (noise - latents), and the loss is the MSE over the tokens whose
``t_chunk >= 0`` (uneven-shard pad slots carry t = -1), normalised by the
count of those tokens times ``in_dim``.

Weights keep the JAX layout ``[in, out]``, applied as ``x @ w``, each fp32
master cast to ``cfg.dtype`` at its product, so a parameter tree carries
across unchanged (``convert.dit_params_from_numpy``).

Layouts (``build_magi_dit(groups=)``, a ``make_parallel_groups(dp=, cp=)``
result; no tp and no pp, as in JAX):

- cp = 1: each layer's self-attention is one flex-attention call over the
  whole mask (``ops.flex_attn_with_meta`` on a plan built once at the
  harness's blocking), the JAX ``dist_attn_local`` at cp = 1 with its
  identity dispatch;
- cp > 1: each rank feeds its dispatched shard of the tokens
  (:meth:`MagiDiT.shard`, RoPE on :meth:`MagiDiT.position_ids`) and every
  layer runs ``parallel.dist_attn.dist_attn_local`` on the plan of
  ``_common.plan_flex_attn`` (``build_dist_attn_plan`` at the blocking of
  ``resolve_harness_blocking``), as JAX ``build_magi_dit`` plans it;
- dp: each dp rank feeds its rows of the batch. The loss count and the
  gradients are summed over the dp x cp ranks (``sum_groups``,
  ``grad_groups``), the psums of the JAX model's ``shard_map``.

On CUDA tensors every self-attention forward runs ``flex_fwd_hb`` at the
default head_block G (``n_heads / n_kv_heads``; ``flex_fwd`` at G = 1) and
every backward ``flex_dq`` and ``flex_dkv``, at ``DiTConfig``'s head_dim 32
in bfloat16 (the wgmma walks) or float32 (the CUDA-core walks); on CPU
tensors their plain versions. ``cfg.remat`` runs each block under
``torch.utils.checkpoint`` (non-reentrant), as the JAX model wraps it in
``jax.checkpoint``: the backward runs the block's forward again, its
attention kernels and casts included.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flex_attn import flex_attn_with_meta
from ._common import make_model_train_step

LAYER_KEYS = ("ada_w1", "ada_w2", "wq", "wk", "wv", "wo", "xwq", "xwk", "xwv", "xwo", "w_up",
              "w_down")
TOP_KEYS = ("patch_in", "t_embed_w1", "t_embed_w2", "final_ada", "patch_out")
T_EMBED_DIM = 256  # the sinusoidal timestep embedding's width


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_dim: int = 16  # latent channels per token (VAE patch)
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 32
    ffn_hidden: int = 512
    text_dim: int = 64
    text_len: int = 64
    rope_theta: float = 10000.0
    dtype: str = "float32"
    # rerun each DiT block in backward (torch.utils.checkpoint), the memory
    # and compute trade of LlamaConfig.remat
    remat: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def chunk_causal_mask(total: int, chunk_tokens: int):
    """The Magi-1 attention pattern: chunk i attends [0, end_of_chunk_i)
    fully. Returns (q_ranges, k_ranges, attn_type_map) naive lists."""
    qr, kr, ts = [], [], []
    c = 0
    while c < total:
        e = min(c + chunk_tokens, total)
        qr.append((c, e))
        kr.append((0, e))
        ts.append(0)  # FULL
        c = e
    return qr, kr, ts


def init_dit_params(generator: torch.Generator, cfg: DiTConfig) -> dict:
    """Parameter tree (fp32 masters) on the generator's device: each dense
    matrix normal times 1/sqrt(fan_in), the adaLN and output projections
    zero (adaLN-zero) — the JAX ``init_dit_params`` scheme (other random
    numbers: JAX's keys and a torch generator give different draws)."""
    dev = generator.device

    def dense(shape):
        return torch.randn(shape, generator=generator, device=dev) * shape[0] ** -0.5

    def zeros(shape):
        return torch.zeros(shape, device=dev)

    d, hd, hq, hk = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layers = [
        {
            "ada_w1": dense((d, d)),
            "ada_w2": zeros((d, 6 * d)),
            "wq": dense((d, hq * hd)),
            "wk": dense((d, hk * hd)),
            "wv": dense((d, hk * hd)),
            "wo": zeros((hq * hd, d)),
            "xwq": dense((d, hq * hd)),
            "xwk": dense((cfg.text_dim, hq * hd)),
            "xwv": dense((cfg.text_dim, hq * hd)),
            "xwo": zeros((hq * hd, d)),
            "w_up": dense((d, cfg.ffn_hidden)),
            "w_down": zeros((cfg.ffn_hidden, d)),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "patch_in": dense((cfg.in_dim, d)),
        "t_embed_w1": dense((T_EMBED_DIM, d)),
        "t_embed_w2": dense((d, d)),
        "final_ada": zeros((d, 2 * d)),
        "patch_out": zeros((d, cfg.in_dim)),
        "layers": layers,
    }


def _timestep_embedding(t: torch.Tensor, dim: int = T_EMBED_DIM) -> torch.Tensor:
    """Sinusoidal embedding of diffusion time t in [0, 1] ([...] -> [..., dim])."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    ang = t.float()[..., None] * 1000.0 * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free LayerNorm (adaLN supplies scale and shift)."""
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float, hd: int) -> torch.Tensor:
    """RoPE on flat positions: x [t, h, hd], pos [t]."""
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(x.device).float()[:, None] * freqs  # [t, half]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _cross_attn_local(xq_in, text_k, text_v, hq: int, hd: int) -> torch.Tensor:
    """Rank-local dense cross-attention to the replicated text stream:
    xq_in [t_loc, hq * hd], text_k / text_v [t_text, hq * hd]."""
    t_loc, t_text = xq_in.shape[0], text_k.shape[0]
    q = xq_in.reshape(t_loc, hq, hd)
    k = text_k.reshape(t_text, hq, hd)
    v = text_v.reshape(t_text, hq, hd)
    z = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    p = torch.softmax(z.float(), dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(t_loc, hq * hd)


def _block(x, c, pos, text, layer: dict, cfg: DiTConfig, attention):
    """One DiT block on x [t_loc, dim] in ``cfg.dtype``: adaLN-modulated
    self-attention (``attention(q, k, v)``), the cross-attention to text,
    the gated MLP."""
    dt = cfg.torch_dtype
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(name):
        return layer[name].to(dt)

    mod = F.silu(c @ w("ada_w1")) @ w("ada_w2")  # [t_loc, 6 dim]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _ln(x) * (1 + sc1) + sh1
    q = _rope((h @ w("wq")).view(-1, hq, hd), pos, cfg.rope_theta, hd)
    k = _rope((h @ w("wk")).view(-1, hk, hd), pos, cfg.rope_theta, hd)
    v = (h @ w("wv")).view(-1, hk, hd)
    out = attention(q, k, v)
    x = x + g1 * (out.to(dt).reshape(-1, hq * hd) @ w("wo"))

    # cross-attention to text (replicated, rank-local, no collective)
    xq = _ln(x) @ w("xwq")
    tk = text.to(dt) @ w("xwk")
    tv = text.to(dt) @ w("xwv")
    x = x + _cross_attn_local(xq, tk, tv, hq, hd) @ w("xwo")

    h2 = _ln(x) * (1 + sc2) + sh2
    return x + g2 * (F.gelu(h2 @ w("w_up"), approximate="tanh") @ w("w_down"))


def dit_forward_local(params: dict, lat, pos, t_chunk, text, cfg: DiTConfig, attention):
    """One stream's forward on this rank: noised latents [t_loc, in_dim] ->
    predicted velocity [t_loc, in_dim] in float32. ``pos`` [t_loc] are the
    global positions, ``t_chunk`` [t_loc] the per-token diffusion time,
    ``text`` [text_len, text_dim] the replicated conditioning, and
    ``attention(q, k, v)`` the self-attention over this rank's tokens (the
    JAX version's tables, plan and params)."""
    dt = cfg.torch_dtype
    x = lat.to(dt) @ params["patch_in"].to(dt)
    # per-TOKEN conditioning: chunks carry independent t (AR denoising)
    temb = _timestep_embedding(t_chunk)
    c = F.silu(temb.to(dt) @ params["t_embed_w1"].to(dt)) @ params["t_embed_w2"].to(dt)
    for layer in params["layers"]:
        if cfg.remat:
            # save only the block's input; the backward runs it again
            x = checkpoint(_block, x, c, pos, text, layer, cfg, attention, use_reentrant=False)
        else:
            x = _block(x, c, pos, text, layer, cfg, attention)
    fsh, fsc = (c @ params["final_ada"].to(dt)).chunk(2, dim=-1)
    x = _ln(x) * (1 + fsc) + fsh
    return (x @ params["patch_out"].to(dt)).float()


class DiTLayer(nn.Module):
    """One block's weights (fp32 masters, ``[in, out]``)."""

    def __init__(self, weights: dict):
        super().__init__()
        for name in LAYER_KEYS:
            setattr(self, name, nn.Parameter(weights[name]))


class MagiDiT(nn.Module):
    """The DiT over one chunk-causal plan.

    ``lat`` (noised latents), ``target_v``, ``t_chunk`` and ``pos`` are [b,
    t] (+ ``in_dim``): the whole streams at cp = 1, this rank's dispatched
    shard under cp (:meth:`shard`; ``t_chunk`` with ``pad_value=-1``, so
    that uneven-shard pad slots stay out of the loss); ``text`` is [b,
    text_len, text_dim], replicated over cp. ``dp_group`` splits the batch
    rows; ``sum_groups`` are the groups the loss count and the gradients are
    summed over (the dp x cp group)."""

    def __init__(self, cfg: DiTConfig, meta, params: dict, head_block: int = 1, *, plan=None,
                 attn_params=None, dispatch_meta=None, group=None, cp_group=None,
                 dp_group=None, sum_groups=()):
        super().__init__()
        self.cfg, self.meta = cfg, meta
        self.head_block = int(head_block)
        self.plan, self.attn_params = plan, attn_params
        self.dispatch_meta, self.group = dispatch_meta, group
        self.cp_group = group if cp_group is None else cp_group
        self.dp_group = dp_group
        self.sum_groups = tuple(sum_groups)
        for name in TOP_KEYS:
            setattr(self, name, nn.Parameter(params[name]))
        self.layers = nn.ModuleList(DiTLayer(p) for p in params["layers"])

    def param_tree(self) -> dict:
        """The parameters in the tree of :func:`init_dit_params`."""
        return {**{name: getattr(self, name) for name in TOP_KEYS},
                "layers": [{name: getattr(layer, name) for name in LAYER_KEYS}
                           for layer in self.layers]}

    def attention(self, q, k, v):
        """q [t, hq, d], k/v [t, hk, d] -> out [t, hq, d] over the plan
        (this rank's shard and the cp plan under cp)."""
        if self.group is not None:
            from ..parallel.dist_attn import dist_attn_local

            return dist_attn_local(q, k, v, self.plan, self.attn_params, self.cp_group)[0]
        out, _ = flex_attn_with_meta(q, k, v, self.meta, out_dtype=self.cfg.torch_dtype,
                                     head_block=self.head_block)
        return out

    def grad_groups(self) -> list:
        """(parameters, group) pairs the train step sums gradients over:
        every parameter over dp x cp."""
        params = list(self.parameters())
        return [(params, g) for g in self.sum_groups]

    def forward(self, lat, t_chunk, pos, text):
        """Predicted velocities [b, t, in_dim] in float32 (the JAX
        ``make_forward``'s arguments, in its order)."""
        tree = self.param_tree()
        return torch.stack([
            dit_forward_local(tree, lat1, pos1, tc1, text1, self.cfg, self.attention)
            for lat1, tc1, pos1, text1 in zip(lat, t_chunk, pos, text)
        ])

    def loss(self, noised, target_v, t_chunk, pos, text):
        """Velocity-matching MSE over the tokens with ``t_chunk >= 0`` (of
        all streams), over their count times ``in_dim``. Under dp or cp this
        rank's share: its squared-error sum over the count of every dp x cp
        rank's valid tokens, so that the shares sum to the global loss."""
        from ..utils.instrument import named_scope
        from .llama import _sum_over

        pred = self.forward(noised, t_chunk, pos, text)
        valid = (t_chunk >= 0.0)[..., None]
        err = torch.where(valid, pred - target_v.to(pred.device), 0.0)
        with named_scope("magi_dit_loss_psum"):
            count = _sum_over(valid.sum().to(torch.float32).detach(), self.sum_groups)
        return (err.float() ** 2).sum() / torch.clamp(count * self.cfg.in_dim, min=1.0)

    def make_train_step(self, optimizer: torch.optim.Optimizer):
        """``step(noised, target_v, t_chunk, pos, text)``: forward, backward
        and one ``optimizer`` update in place, the gradients summed over
        :meth:`grad_groups`; returns the global loss (the JAX
        ``make_train_step``, whose state is functional)."""
        return make_model_train_step(self, optimizer)

    def dp_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This dp rank's rows of a [b, ...] batch (``text``, say); all of
        them without dp."""
        import torch.distributed as dist

        if self.dp_group is None:
            return x
        dp, d = dist.get_world_size(self.dp_group), dist.get_rank(self.dp_group)
        if x.shape[0] % dp:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over dp={dp}")
        rows = x.shape[0] // dp
        return x[d * rows:(d + 1) * rows]

    def shard(self, x: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
        """This rank's part of a global [b, total, ...] token tensor: its dp
        rank's rows (:meth:`dp_rows`), and under cp its dispatched tokens of
        axis 1 (pad slots of an uneven shard take ``pad_value``: -1 for
        ``t_chunk``)."""
        import torch.distributed as dist

        from ..parallel.dispatch import _perm, _take_rows

        x = self.dp_rows(x)
        if self.group is None:
            return x
        perm = _perm(self.dispatch_meta, dist.get_rank(self.group), x.device)
        return torch.stack([_take_rows(r, perm, self.dispatch_meta.total_seqlen, pad_value)
                            for r in x])

    def position_ids(self) -> torch.Tensor:
        """Global positions of this rank's dispatched tokens [shard] (int64,
        on the CPU; pad slots read 0): RoPE's ``pos``; all positions at
        cp = 1."""
        import torch.distributed as dist

        from ..parallel.dispatch import position_ids

        if self.group is None:
            return torch.arange(self.meta.total_q, dtype=torch.int64)
        rank = dist.get_rank(self.group)
        return torch.from_numpy(position_ids(self.dispatch_meta, rank).astype(np.int64))

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's [b_rank, shard, ...] (a velocity) back to the global
        [b, total, ...] in natural token order, on every rank (a collective
        over the cp and dp groups)."""
        import torch.distributed as dist

        from ..parallel.dispatch import undispatch

        if self.group is not None:
            y = torch.stack([undispatch(r, self.dispatch_meta, self.group) for r in y])
        if self.dp_group is not None:
            parts = [torch.empty_like(y) for _ in range(dist.get_world_size(self.dp_group))]
            dist.all_gather(parts, y.contiguous(), group=self.dp_group)
            y = torch.cat(parts)
        return y


def build_magi_dit(cfg: DiTConfig, total_tokens: int, chunk_tokens: int, *, groups=None,
                   dispatch_chunk: int | None = None, block_q: int | None = None,
                   block_k: int | None = None, device=None, params: dict | None = None,
                   seed: int = 0) -> MagiDiT:
    """Plan the chunk-causal attention once and bundle the model on
    ``device``: the counterpart of the JAX ``build_magi_dit``, whose
    dispatch meta is ``model.dispatch_meta`` here (None at cp = 1).

    ``chunk_tokens``: tokens per AR video chunk (frames x patches).
    ``groups``: a ``make_parallel_groups(dp=, cp=)`` result (every rank
    calling this with the same arguments and weights); pp and tp raise, as
    the JAX model has neither. ``dispatch_chunk``: the cp load-balancing
    chunk (default ``total / (MAGI_ATTENTION_MIN_CHUNKS_PER_RANK x cp)``).
    ``block_q`` / ``block_k`` pin the tile; else the blocking and head_block
    resolve through ``resolve_harness_blocking``. ``params``: a full tree
    as :func:`init_dit_params` returns it (``convert.dit_params_from_numpy``
    carries the JAX package's over); without it the weights are drawn from
    ``seed`` on ``device``. The default device is the card; ``device="cpu"``
    runs the plain versions. Raises without a card when asked for one."""
    from .. import env
    from .llama import _layout, _plan

    device = torch.device("cuda" if device is None else device)
    if groups is not None and (groups.sizes[0] > 1 or groups.sizes[3] > 1):
        raise ValueError(f"MagiDiT runs dp x cp only; got (pp, dp, cp, tp) = {groups.sizes}")
    lay = _layout(groups)
    cp = 1 if groups is None else groups.sizes[2]
    if dispatch_chunk is None:
        dispatch_chunk = max(total_tokens // (env.min_chunks_per_rank() * cp), 1)
    qr, kr, ts = chunk_causal_mask(total_tokens, chunk_tokens)
    meta, hb, cp_kw = _plan(cfg, total_tokens, qr, kr, ts, lay, block_q=block_q,
                            block_k=block_k, device=device, chunk_size=dispatch_chunk,
                            overlap_config=None, who="build_magi_dit")
    if params is None:
        params = init_dit_params(torch.Generator(device=device).manual_seed(seed), cfg)

    def to_dev(t):
        if not torch.is_tensor(t):
            t = torch.from_numpy(np.ascontiguousarray(t))
        # a copy: the model trains its own, the caller's tree stays as given
        return t.detach().to(device=device, dtype=torch.float32, copy=True).contiguous()

    params = {**{n: to_dev(params[n]) for n in TOP_KEYS},
              "layers": [{n: to_dev(p[n]) for n in LAYER_KEYS} for p in params["layers"]]}
    return MagiDiT(cfg, meta, params, head_block=hb, dp_group=lay["dp"],
                   sum_groups=lay["dpcp"], **cp_kw)
