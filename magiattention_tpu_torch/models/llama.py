"""Llama-style decoder trained with context-parallel flex attention.

The counterpart of the JAX package's ``models/llama.py`` at dp=1: the same
configuration, parameter tree and initialisation scheme, the same layer
(RMSNorm, RoPE on global position ids, GQA attention, SwiGLU MLP), each
fp32 master weight cast to ``cfg.dtype`` at its product, and the same
masked next-token loss. Weights keep the JAX layout ``[in, out]`` and are
applied as ``x @ w`` (no ``nn.Linear``), so a parameter tree carries across
unchanged (``convert.llama_params_from_numpy``).

Two layouts:

- cp=1 (no ``cp_group``): attention calls flex attention directly
  (``ops.flex_attn_with_meta`` on a plan built once per mask). The JAX
  model's ``dist_attn_local`` at cp=1 is one flex-attention call over the
  whole mask with an identity dispatch, so both compute the same loss and
  gradients;
- cp > 1 (``cp_group``: one process per rank, parameters replicated):
  each rank feeds its dispatched shard of the tokens (:meth:`MagiLlama.shard`,
  RoPE on :meth:`MagiLlama.position_ids`), every layer's attention runs
  ``parallel.dist_attn.dist_attn_local`` on the plan of
  ``_common.plan_flex_attn``, :meth:`MagiLlama.loss` is this rank's masked
  CE sum over the global token count, and ``make_model_train_step`` sums
  the parameter gradients over the group after the backward (the psums of
  the JAX model's ``shard_map``). A ``comm.HierCpGroups`` ``cp_group``
  (the JAX model's ``cp_axis=(inter, intra)``) plans hierarchical
  two-level comm for the attention; the loss count, the gradient sum and
  the shards use its flat group.

Data, tensor and pipeline parallelism (``llama_pp``) and rematerialisation
are not ported yet: ``cfg.remat`` is kept so that configurations carry
across, and the builder refuses it.

The builder resolves ``(block_q, block_k, head_block)`` once through
``_common.resolve_harness_blocking``, as the JAX builder does: by default
the row-major grid at head_block G (``n_heads / n_kv_heads``), which the
model passes to every attention call. On CUDA tensors every attention
forward then runs ``flex_fwd_hb`` (``flex_fwd`` at G = 1, or under a
``MAGI_ATTENTION_HEAD_BLOCK=1`` pin) and every backward ``flex_dq`` and
``flex_dkv``, at any cp size; on CPU tensors their plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.block_meta import FlexAttnBlockMeta, build_block_meta
from ..ops.flex_attn import flex_attn_with_meta
from ._common import masked_ce_sums, plan_flex_attn, resolve_harness_blocking

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn_hidden: int = 5632
    rope_theta: float = 500000.0
    dtype: str = "bfloat16"
    # recompute each layer in backward: not in this slice (the builder refuses it)
    remat: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(generator: torch.Generator, cfg: LlamaConfig) -> dict:
    """Parameter tree (fp32 master weights) on the generator's device: each
    matrix normal times 1/sqrt(fan_in), the embedding normal times 0.02,
    norms 1 — the JAX ``init_params`` scheme (other random numbers: JAX's
    keys and a torch generator give different draws)."""
    dev = generator.device

    def dense(shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return torch.randn(shape, generator=generator, device=dev) * scale

    hq, hk = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                "wq": dense((cfg.dim, hq)),
                "wk": dense((cfg.dim, hk)),
                "wv": dense((cfg.dim, hk)),
                "wo": dense((hq, cfg.dim)),
                "w_gate": dense((cfg.dim, cfg.ffn_hidden)),
                "w_up": dense((cfg.dim, cfg.ffn_hidden)),
                "w_down": dense((cfg.ffn_hidden, cfg.dim)),
                "attn_norm": torch.ones((cfg.dim,), device=dev),
                "mlp_norm": torch.ones((cfg.dim,), device=dev),
            }
        )
    return {
        "embed": dense((cfg.vocab_size, cfg.dim), scale=0.02),
        "layers": layers,
        "final_norm": torch.ones((cfg.dim,), device=dev),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


def _rms_norm(x, w, eps=1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rope(x, pos_ids, theta, head_dim):
    """x [t, h, hd]; pos_ids [t] global positions."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = pos_ids.float()[:, None] * freqs[None, :]  # [t, half]
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


class LlamaLayer(nn.Module):
    """One decoder layer's weights (fp32 masters, ``[in, out]``)."""

    def __init__(self, weights: dict):
        super().__init__()
        for name in LAYER_KEYS:
            setattr(self, name, nn.Parameter(weights[name]))

    def forward(self, x, pos, cfg: LlamaConfig, attention):
        """x [t, dim] in ``cfg.dtype``; the JAX ``_layer_local`` without tp."""
        dt = cfg.torch_dtype
        t = x.shape[0]
        h = _rms_norm(x, self.attn_norm)
        q = (h @ self.wq.to(dt)).view(t, -1, cfg.head_dim)
        k = (h @ self.wk.to(dt)).view(t, -1, cfg.head_dim)
        v = (h @ self.wv.to(dt)).view(t, -1, cfg.head_dim)
        q = _rope(q, pos, cfg.rope_theta, cfg.head_dim)
        k = _rope(k, pos, cfg.rope_theta, cfg.head_dim)
        out = attention(q, k, v)
        x = x + out.reshape(t, -1) @ self.wo.to(dt)

        h = _rms_norm(x, self.mlp_norm)
        gate = nn.functional.silu(h @ self.w_gate.to(dt))
        up = h @ self.w_up.to(dt)
        return x + (gate * up) @ self.w_down.to(dt)


class MagiLlama(nn.Module):
    """The decoder over one packed token stream and its flex plan.

    ``tokens``, ``labels`` and ``pos`` are [t] (one stream) or [b, t]
    (streams of one mask, as the JAX model's batch axis): the whole stream
    at cp=1, this rank's dispatched shard under cp; ``pos`` holds the
    global position ids RoPE reads. ``head_block`` (q heads per forward
    work item) is the builder's resolved choice. Under cp, ``plan``,
    ``attn_params``, ``dispatch_meta`` and ``group`` are the rank's
    distributed plan and flat process group, and ``cp_group`` the group
    the attention's casts run over (``group``, or a hierarchical plan's
    ``HierCpGroups``); ``meta`` is then None."""

    def __init__(self, cfg: LlamaConfig, meta: FlexAttnBlockMeta | None, params: dict,
                 head_block: int = 1, *, plan=None, attn_params=None, dispatch_meta=None,
                 group=None, cp_group=None):
        super().__init__()
        self.cfg = cfg
        self.meta = meta
        self.head_block = int(head_block)
        self.plan, self.attn_params = plan, attn_params
        self.dispatch_meta, self.group = dispatch_meta, group
        self.cp_group = group if cp_group is None else cp_group
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ModuleList(LlamaLayer(p) for p in params["layers"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"])

    def param_tree(self) -> dict:
        """The parameters in the tree of :func:`init_params`."""
        return {
            "embed": self.embed,
            "layers": [{name: getattr(layer, name) for name in LAYER_KEYS} for layer in self.layers],
            "final_norm": self.final_norm,
            "lm_head": self.lm_head,
        }

    def attention(self, q, k, v):
        """q [t, hq, d], k/v [t, hk, d] -> out [t, hq, d] over the plan
        (this rank's shard and the cp plan under cp)."""
        if self.group is not None:
            from ..parallel.dist_attn import dist_attn_local

            return dist_attn_local(q, k, v, self.plan, self.attn_params, self.cp_group)[0]
        out, _ = flex_attn_with_meta(q, k, v, self.meta, out_dtype=self.cfg.torch_dtype,
                                     head_block=self.head_block)
        return out

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's dispatched rows of a global [..., total] token-axis
        tensor (tokens or labels; the last axis is the token axis); the
        tensor itself at cp=1."""
        if self.group is None:
            return x
        return x[..., self.position_ids().to(x.device)]

    def position_ids(self) -> torch.Tensor:
        """Global positions of this rank's dispatched tokens [shard] (int64,
        on the CPU): RoPE's ``pos`` under cp."""
        import torch.distributed as dist

        from ..parallel.dispatch import position_ids

        rank = dist.get_rank(self.group)
        return torch.from_numpy(position_ids(self.dispatch_meta, rank).astype(np.int64))

    def _forward_one(self, tokens, pos):
        dt = self.cfg.torch_dtype
        x = self.embed.to(dt)[tokens]
        for layer in self.layers:
            x = layer(x, pos, self.cfg, self.attention)
        x = _rms_norm(x, self.final_norm)
        return (x @ self.lm_head.to(dt)).float()

    def forward(self, tokens, pos):
        """Logits [..., t, vocab] in float32."""
        if tokens.dim() == 1:
            return self._forward_one(tokens, pos)
        return torch.stack([self._forward_one(t, p) for t, p in zip(tokens, pos)])

    def loss(self, tokens, labels, pos):
        """Mean next-token CE over the positions with label >= 0 (of all
        streams, as the JAX model sums over its batch axis). Under cp, this
        rank's share: its CE sum over the count of every rank's positions,
        so that the shares sum to the global mean."""
        logits = self.forward(tokens, pos)
        loss_sum, count = masked_ce_sums(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
        if self.group is not None:
            import torch.distributed as dist

            count = count.detach().clone()
            dist.all_reduce(count, group=self.group)
        return loss_sum / torch.clamp(count, min=1.0)


def _naive(ranges):
    return ranges.to_naive_ranges() if hasattr(ranges, "to_naive_ranges") else ranges


def build_magi_llama(
    cfg: LlamaConfig,
    total_seqlen: int,
    q_ranges,
    k_ranges,
    attn_type_map,
    *,
    params: dict | None = None,
    seed: int = 0,
    block_q: int | None = None,
    block_k: int | None = None,
    device: str | torch.device = "cuda",
    cp_group=None,
    chunk_size: int | None = None,
    overlap_config=None,
) -> MagiLlama:
    """Plan the attention for one mask (once) and bundle the model on
    ``device``: the counterpart of the JAX ``build_magi_llama``, whose
    dispatch meta is ``model.dispatch_meta`` here (None at cp=1).

    With ``cp_group`` (a ``torch.distributed`` group of the cp ranks, one
    process each, every rank calling this with the same arguments and
    weights) the plan is ``_common.plan_flex_attn``'s at ``chunk_size``
    (required) and ``overlap_config`` (default degree 0); feed each rank
    ``model.shard(tokens)``, ``model.shard(labels)`` and
    ``model.position_ids()``. A ``comm.HierCpGroups`` (from
    ``comm.make_hier_cp_groups``) plans hierarchical two-level comm over
    its (n_inter, n_intra) layout, the counterpart of JAX ``build_magi_llama``'s
    ``cp_axis=(inter, intra)``.

    ``params`` is a tree as :func:`init_params` returns (e.g. carried over
    by ``convert.llama_params_from_numpy``); without it the weights are
    drawn from ``seed`` on ``device``. The default device is the card;
    ``device="cpu"`` runs the plain versions. Raises without a card when
    asked for one. ``block_q``/``block_k`` pin the tile; the blocking and
    head_block resolve through ``resolve_harness_blocking``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_magi_llama(device='cuda'): no CUDA device is available; "
            "pass device='cpu' to run the plain versions"
        )
    if cfg.remat:
        raise NotImplementedError(
            "cfg.remat (layer rematerialisation) is not in the port yet (ROADMAP queue A item 16)"
        )
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"n_heads {cfg.n_heads} is not a multiple of n_kv_heads {cfg.n_kv_heads}")
    qn, kn, types = _naive(q_ranges), _naive(k_ranges), [int(t) for t in attn_type_map]
    cp = {}
    if cp_group is not None:
        from ..common.axes import cp_axis_size, split_cp_group

        if chunk_size is None:
            raise ValueError("build_magi_llama(cp_group=...) needs a chunk_size")
        flat, shape = split_cp_group(cp_group)
        plan, attn_params, mq = plan_flex_attn(
            cfg, total_seqlen, qn, kn, types, chunk_size=chunk_size,
            cp_size=cp_axis_size(cp_group), block_q=block_q, block_k=block_k,
            overlap_config=overlap_config, cp_mesh_shape=shape, group=flat, device=device,
        )
        meta, hb = None, attn_params.head_block
        cp = dict(plan=plan, attn_params=attn_params, dispatch_meta=mq, group=flat,
                  cp_group=cp_group)
    else:
        bq, bk, hb = resolve_harness_blocking(cfg, qn, kn, types, total_seqlen, 1, block_q,
                                              block_k, device=device)
        meta = build_block_meta(qn, kn, types, total_seqlen, total_seqlen, block_q=bq,
                                block_k=bk)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(seed), cfg)

    def to_dev(t):
        return t.detach().to(device=device, dtype=torch.float32)

    params = {
        "embed": to_dev(params["embed"]),
        "layers": [{n: to_dev(p[n]) for n in LAYER_KEYS} for p in params["layers"]],
        "final_norm": to_dev(params["final_norm"]),
        "lm_head": to_dev(params["lm_head"]),
    }
    return MagiLlama(cfg, meta, params, head_block=hb, **cp)
