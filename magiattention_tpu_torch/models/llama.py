"""Llama-style decoder trained with context-parallel flex attention.

The counterpart of the JAX package's ``models/llama.py``: the same
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

``cfg.remat`` rematerialises each decoder layer in the backward
(``torch.utils.checkpoint``, non-reentrant), as the JAX model wraps its
layer in ``jax.checkpoint``: only each layer's input is saved, and the
backward runs the layer's forward again, attention kernels and (under cp)
the attention's casts and max-logit all-reduce included, on every rank in
the same order. Telemetry, guard and census records therefore count the
recomputed calls too (JAX counts a traced program once).

Data and tensor parallelism compose with cp (``_common.make_parallel_groups``
lays the ranks out row-major over (pp, dp, cp, tp), as the JAX mesh):

- dp (``dp_group``): each dp rank feeds its rows of the [b, t] batch
  (:meth:`MagiLlama.shard`); the loss count and the gradients are summed
  over the dp x cp ranks (``sum_groups``), as the JAX model psums over cp
  and dp;
- tp (``tp_group``): Megatron's column / row sharding, as JAX's ``P(None,
  tp)`` / ``P(tp, None)`` specs shard the weights: a tp rank holds a
  contiguous head block of ``wq``, ``wk``, ``wv`` and a slice of ``w_gate``
  / ``w_up`` (columns), the matching rows of ``wo`` / ``w_down``, and
  ``embed``, ``lm_head`` and the norms whole. The column products' input
  goes through ``comm.replicated`` (identity forward, all-reduce
  backward) and the row products' output through
  ``comm.reduce_over_group`` (the JAX model's psum after ``wo`` and
  ``w_down``), so that each tp rank's gradient is its slice of the
  one-card gradient and the replicated weights' gradients are whole on
  every tp rank: the trainer sums nothing over tp. The attention runs at
  the per-rank heads, read off the weights' shapes.

The pipeline (pp) is ``models/llama_pp.py``.

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
from torch.utils.checkpoint import checkpoint

from ..ops.block_meta import FlexAttnBlockMeta, build_block_meta
from ..ops.flex_attn import flex_attn_with_meta
from ._common import (
    ParallelGroups,
    check_tp,
    masked_ce_sums,
    plan_flex_attn,
    resolve_harness_blocking,
)

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm")
TP_COLUMNS = ("wq", "wk", "wv", "w_gate", "w_up")  # sharded on their last (output) axis
TP_ROWS = ("wo", "w_down")  # sharded on their input axis


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
    # recompute each decoder layer in backward (torch.utils.checkpoint):
    # activation memory drops from O(layers x t x dim) to O(t x dim) at
    # about a third more FLOPs
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

    def forward(self, x, pos, cfg: LlamaConfig, attention, tp_group=None):
        """x [t, dim] in ``cfg.dtype``; the JAX ``_layer_local``. Under
        ``tp_group`` the weights are this rank's shards and the head counts
        are read off their shapes."""
        from ..comm.primitives import reduce_over_group, replicated

        dt = cfg.torch_dtype
        t = x.shape[0]

        def column_input(h):
            return h if tp_group is None else replicated(h, tp_group)

        def row_output(y):
            return y if tp_group is None else reduce_over_group(y, tp_group)

        h = column_input(_rms_norm(x, self.attn_norm))
        q = (h @ self.wq.to(dt)).view(t, -1, cfg.head_dim)
        k = (h @ self.wk.to(dt)).view(t, -1, cfg.head_dim)
        v = (h @ self.wv.to(dt)).view(t, -1, cfg.head_dim)
        q = _rope(q, pos, cfg.rope_theta, cfg.head_dim)
        k = _rope(k, pos, cfg.rope_theta, cfg.head_dim)
        out = attention(q, k, v)
        x = x + row_output(out.reshape(t, -1) @ self.wo.to(dt))

        h = column_input(_rms_norm(x, self.mlp_norm))
        gate = nn.functional.silu(h @ self.w_gate.to(dt))
        up = h @ self.w_up.to(dt)
        return x + row_output((gate * up) @ self.w_down.to(dt))


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
    ``HierCpGroups``); ``meta`` is then None. ``dp_group`` and ``tp_group``
    (None: no such axis) split the batch rows and the layers' weights;
    ``sum_groups`` are the groups the loss count and the gradients are
    summed over, one after the other (the dp x cp group of
    ``make_parallel_groups``, or the cp and dp groups; default: ``group``)."""

    def __init__(self, cfg: LlamaConfig, meta: FlexAttnBlockMeta | None, params: dict,
                 head_block: int = 1, *, plan=None, attn_params=None, dispatch_meta=None,
                 group=None, cp_group=None, dp_group=None, tp_group=None, sum_groups=None):
        super().__init__()
        self.cfg = cfg
        self.meta = meta
        self.head_block = int(head_block)
        self.plan, self.attn_params = plan, attn_params
        self.dispatch_meta, self.group = dispatch_meta, group
        self.cp_group = group if cp_group is None else cp_group
        self.dp_group, self.tp_group = dp_group, tp_group
        if sum_groups is None:
            sum_groups = () if group is None else (group,)
        self.sum_groups = tuple(sum_groups)
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

    def grad_groups(self) -> list:
        """(parameters, group) pairs the train step sums gradients over:
        every parameter over dp x cp (the tp pair in the layers already
        leaves each tp rank its slice of the one-card gradient)."""
        params = list(self.parameters())
        return [(params, g) for g in self.sum_groups]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a global [b, total] (or [total]) token-axis
        tensor (tokens or labels): its dp rank's rows of the batch axis,
        and under cp its dispatched tokens of the last axis."""
        import torch.distributed as dist

        if self.dp_group is not None:
            if x.dim() < 2:
                raise ValueError("under dp, shard takes a [b, total] batch")
            dp, d = dist.get_world_size(self.dp_group), dist.get_rank(self.dp_group)
            if x.shape[0] % dp:
                raise ValueError(f"a batch of {x.shape[0]} rows does not split over dp={dp}")
            rows = x.shape[0] // dp
            x = x[d * rows:(d + 1) * rows]
        if self.group is None:
            return x
        return x[..., self.position_ids().to(x.device)]

    def position_ids(self) -> torch.Tensor:
        """Global positions of this rank's dispatched tokens [shard] (int64,
        on the CPU): RoPE's ``pos`` under cp; all positions at cp=1."""
        import torch.distributed as dist

        from ..parallel.dispatch import position_ids

        if self.group is None:
            return torch.arange(self.meta.total_q, dtype=torch.int64)
        rank = dist.get_rank(self.group)
        return torch.from_numpy(position_ids(self.dispatch_meta, rank).astype(np.int64))

    def _run_layers(self, x, pos):
        for layer in self.layers:
            if self.cfg.remat:
                # save only the layer's input; the backward runs it again
                x = checkpoint(layer, x, pos, self.cfg, self.attention, self.tp_group,
                               use_reentrant=False)
            else:
                x = layer(x, pos, self.cfg, self.attention, self.tp_group)
        return x

    def _head(self, x):
        x = _rms_norm(x, self.final_norm)
        return (x @ self.lm_head.to(self.cfg.torch_dtype)).float()

    def _forward_one(self, tokens, pos):
        x = self.embed.to(self.cfg.torch_dtype)[tokens]
        return self._head(self._run_layers(x, pos))

    def forward(self, tokens, pos):
        """Logits [..., t, vocab] in float32."""
        if tokens.dim() == 1:
            return self._forward_one(tokens, pos)
        return torch.stack([self._forward_one(t, p) for t, p in zip(tokens, pos)])

    def loss(self, tokens, labels, pos):
        """Mean next-token CE over the positions with label >= 0 (of all
        streams, as the JAX model sums over its batch axis). Under dp or cp,
        this rank's share: its CE sum over the count of every dp x cp rank's
        positions, so that the shares sum to the global mean (the tp ranks
        of a cell hold the same share)."""
        logits = self.forward(tokens, pos)
        loss_sum, count = masked_ce_sums(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
        return loss_sum / torch.clamp(_sum_over(count.detach(), self.sum_groups), min=1.0)


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """A copy of ``x`` summed over each group in turn (no gradient)."""
    import torch.distributed as dist

    x = x.clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


def _naive(ranges):
    return ranges.to_naive_ranges() if hasattr(ranges, "to_naive_ranges") else ranges


def _group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def _layout(groups: ParallelGroups | None, cp_group=None) -> dict:
    """The model's groups from one ``make_parallel_groups`` result, or from
    a cp group alone (not both): {pp, dp, cp, tp, dpcp and ppdpcp (tuples
    of groups to sum over in turn)}."""
    from ..common.axes import split_cp_group

    if groups is None:
        dpcp = () if cp_group is None else (split_cp_group(cp_group)[0],)
        return dict(pp=None, dp=None, cp=cp_group, tp=None, dpcp=dpcp, ppdpcp=dpcp)
    if cp_group is not None:
        raise ValueError("pass the groups as one make_parallel_groups result or cp_group alone, "
                         "not both")
    return dict(pp=groups.pp, dp=groups.dp, cp=groups.cp, tp=groups.tp,
                dpcp=() if groups.dpcp is None else (groups.dpcp,),
                ppdpcp=() if groups.ppdpcp is None else (groups.ppdpcp,))


def _plan(cfg, total_seqlen, q_ranges, k_ranges, attn_type_map, lay: dict, *, block_q,
          block_k, device, chunk_size, overlap_config, who: str):
    """The attention plan shared by the Llama builders: (meta, head_block,
    the model's cp keywords). Checks the card, the GQA ratio and tp."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device='cuda'): no CUDA device is available; "
            "pass device='cpu' to run the plain versions"
        )
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"n_heads {cfg.n_heads} is not a multiple of n_kv_heads {cfg.n_kv_heads}")
    tp = _group_size(lay["tp"])
    check_tp(cfg, tp)
    qn, kn, types = _naive(q_ranges), _naive(k_ranges), [int(t) for t in attn_type_map]
    if lay["cp"] is None:
        bq, bk, hb = resolve_harness_blocking(cfg, qn, kn, types, total_seqlen, 1, block_q,
                                              block_k, device=device, tp=tp)
        meta = build_block_meta(qn, kn, types, total_seqlen, total_seqlen, block_q=bq,
                                block_k=bk)
        return meta, hb, {}
    from ..common.axes import cp_axis_size, split_cp_group

    if chunk_size is None:
        raise ValueError(f"{who}(cp_group=...) needs a chunk_size")
    flat, shape = split_cp_group(lay["cp"])
    plan, attn_params, mq = plan_flex_attn(
        cfg, total_seqlen, qn, kn, types, chunk_size=chunk_size,
        cp_size=cp_axis_size(lay["cp"]), block_q=block_q, block_k=block_k,
        overlap_config=overlap_config, cp_mesh_shape=shape, group=flat, device=device, tp=tp,
    )
    return None, attn_params.head_block, dict(plan=plan, attn_params=attn_params,
                                              dispatch_meta=mq, group=flat,
                                              cp_group=lay["cp"])


def _tp_slice(name: str, a, tp_rank: int, tp: int):
    """Rank ``tp_rank``'s part of one full layer weight ``a`` (a [in, out]
    matrix or a layer-stacked [L, in, out] one; numpy or torch)."""
    if tp == 1 or name not in TP_COLUMNS + TP_ROWS:
        return a
    axis = -1 if name in TP_COLUMNS else -2
    n = a.shape[axis]
    if n % tp:
        raise ValueError(f"{name}'s {n} {'columns' if axis == -1 else 'rows'} do not split "
                         f"over tp={tp}")
    part = slice(tp_rank * n // tp, (tp_rank + 1) * n // tp)
    return a[..., part] if axis == -1 else a[..., part, :]


def shard_llama_params(tree: dict, tp_rank: int, tp: int) -> dict:
    """Tensor-parallel rank ``tp_rank``'s slices of a full parameter tree
    (as :func:`init_params` or the JAX ``init_params`` gives it, numpy or
    torch; or layer-stacked, as ``llama_pp.stack_layer_params``): the
    column blocks of ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` and the row
    blocks of ``wo``, ``w_down``, contiguous, as JAX's ``P(None, tp)`` /
    ``P(tp, None)`` shard them; ``embed``, ``lm_head`` and the norms whole."""
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = {n: _tp_slice(n, a, tp_rank, tp) for n, a in layers.items()}
    else:
        layers = [{n: _tp_slice(n, a, tp_rank, tp) for n, a in layer.items()} for layer in layers]
    return {**tree, "layers": layers}


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
    groups: ParallelGroups | None = None,
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

    ``groups``, a ``make_parallel_groups`` result (in place of
    ``cp_group``), adds data and tensor parallelism (the JAX builder's
    ``dp_axis`` / ``tp_axis``): its dp x cp group sums the gradients in
    one all-reduce. Under tp, ``tp`` must divide both head counts
    (``ValueError`` otherwise).

    ``params`` is a full tree as :func:`init_params` returns (e.g. carried
    over by ``convert.llama_params_from_numpy``); without it the weights
    are drawn from ``seed`` on ``device``. Under tp each rank keeps its
    slices (:func:`shard_llama_params`). The default device is the card;
    ``device="cpu"`` runs the plain versions. Raises without a card when
    asked for one. ``block_q``/``block_k`` pin the tile; the blocking and
    head_block resolve through ``resolve_harness_blocking`` at the per-rank
    heads."""
    device = torch.device(device)
    lay = _layout(groups, cp_group)
    meta, hb, cp = _plan(cfg, total_seqlen, q_ranges, k_ranges, attn_type_map, lay,
                         block_q=block_q, block_k=block_k, device=device, chunk_size=chunk_size,
                         overlap_config=overlap_config, who="build_magi_llama")
    params = _place_params(cfg, params, seed, device, lay["tp"])
    return MagiLlama(cfg, meta, params, head_block=hb, dp_group=lay["dp"], tp_group=lay["tp"],
                     sum_groups=lay["dpcp"], **cp)


def _place_params(cfg, params, seed, device, tp_group) -> dict:
    """The full tree (drawn from ``seed`` when None) as float32 tensors on
    ``device``, cut to this tp rank's slices under ``tp_group``; the
    layer list stays as given (a list, or a stacked dict)."""
    import torch.distributed as dist

    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    if tp_group is not None:
        params = shard_llama_params(params, dist.get_rank(tp_group),
                                    dist.get_world_size(tp_group))

    def to_dev(t):
        if not torch.is_tensor(t):
            t = torch.from_numpy(np.ascontiguousarray(t))
        return t.detach().to(device=device, dtype=torch.float32).contiguous()

    layers = params["layers"]
    layers = ({n: to_dev(layers[n]) for n in LAYER_KEYS} if isinstance(layers, dict)
              else [{n: to_dev(p[n]) for n in LAYER_KEYS} for p in layers])
    return {
        "embed": to_dev(params["embed"]),
        "layers": layers,
        "final_norm": to_dev(params["final_norm"]),
        "lm_head": to_dev(params["lm_head"]),
    }
