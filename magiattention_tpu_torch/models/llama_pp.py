"""Pipeline-parallel Llama trainer: pipeline x data x context x tensor.

The counterpart of the JAX package's ``models/llama_pp.py``, whose layer
stack is one leaf with a leading ``n_layers`` axis sharded ``P('pp')`` and
whose GPipe ticks are a ``lax.scan`` over a ``ppermute`` (its transpose the
backward pipeline). Here one process per rank (``_common.
make_parallel_groups``, row-major over (pp, dp, cp, tp) as the JAX mesh):

- a stage rank holds its ``n_layers / pp`` contiguous layers as
  ``LlamaLayer`` s (rows ``[s L/pp, (s+1) L/pp)`` of the stacked tree), and
  ``embed``, ``final_norm`` and ``lm_head`` whole, as JAX's ``P()`` leaves;
- :meth:`MagiLlamaPP.loss` runs ``nm + pp - 1`` GPipe ticks over this dp
  rank's ``nm`` batch rows (one microbatch each): stage 0 embeds the
  entering microbatch, every stage runs its layers on what it holds, the
  last stage computes the head and the CE, and the activations move one
  stage on with ``comm.ring_shift`` over the pp group, whose backward sends
  their gradients back. Bubble ticks compute nothing (JAX computes on
  clamped indices and masks the result out: the sum is the same);
- every tick's input is tied to the previous tick's shift, so that each
  rank's backward runs the shifts in reverse tick order and every rank of
  a pp group exchanges in step (a stage whose loss is 0 still answers its
  neighbours);
- cp (``dist_attn_local`` over the stage's cp group), tp (the Megatron pair
  of ``models/llama.py``) and ``cfg.remat`` (a checkpoint per layer inside
  the stage, JAX :130-133) compose inside a tick;
- the loss and its count are summed over pp x dp x cp (JAX :201-205); a
  stage's layer gradients over dp x cp, and the replicated weights' over pp
  x dp x cp as well, so that every stage takes the same update of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import ParallelGroups, masked_ce_sums
from .llama import (
    LAYER_KEYS,
    LlamaConfig,
    MagiLlama,
    _layout,
    _place_params,
    _plan,
    _sum_over,
    init_params,
)


def stack_layer_params(params: dict) -> dict:
    """[{k: w}] * L -> {k: w[L, ...]}: one stacked leaf per weight, as JAX's
    ``stack_layer_params`` (torch tensors or numpy arrays)."""
    layers = params["layers"]

    def stack(ws):
        return torch.stack(ws) if torch.is_tensor(ws[0]) else np.stack(ws)

    stacked = {k: stack([lyr[k] for lyr in layers]) for k in layers[0]}
    return {**{k: v for k, v in params.items() if k != "layers"}, "layers": stacked}


def init_pp_params(generator: torch.Generator, cfg: LlamaConfig) -> dict:
    """``init_params``'s weights, layer-stacked."""
    return stack_layer_params(init_params(generator, cfg))


class _Tie(torch.autograd.Function):
    """``value`` unchanged, with ``dep`` made a (zero-gradient) input: it
    keeps a tick's shift in the backward's chain where no value flows."""

    @staticmethod
    def forward(ctx, value, dep):
        ctx.dep_shape = dep.shape
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.needs_input_grad[0] else None), g.new_zeros(ctx.dep_shape)


class MagiLlamaPP(MagiLlama):
    """The pipeline bundle: this rank's stage of the decoder over one
    packed mask. ``tokens``, ``labels`` and ``pos`` are this dp rank's
    [nm, t] rows (under cp its dispatched tokens, :meth:`shard` and
    :meth:`position_ids`), one GPipe microbatch a row. ``pp_group`` and
    ``stage`` place the rank in the pipeline; ``layer_sum_groups`` /
    ``sum_groups`` are what a stage's layer gradients / the loss, its count
    and the replicated weights' gradients are summed over. ``ticks`` counts
    the GPipe ticks the last :meth:`loss` ran, bubbles included."""

    stacked = True  # convert.llama_params_to_numpy gathers the JAX stacked tree

    def __init__(self, cfg, meta, params, head_block=1, *, pp_group=None, stage: int = 0,
                 pp: int = 1, layer_sum_groups=(), **kw):
        super().__init__(cfg, meta, params, head_block, **kw)
        self.pp_group, self.stage, self.pp = pp_group, int(stage), int(pp)
        self.layer_sum_groups = tuple(layer_sum_groups)
        self.ticks = 0

    def grad_groups(self) -> list:
        layer_params = list(self.layers.parameters())
        replicated = [self.embed, self.final_norm, self.lm_head]
        return ([(layer_params, g) for g in self.layer_sum_groups]
                + [(replicated, g) for g in self.sum_groups])

    def forward(self, tokens, pos):
        raise NotImplementedError("a pipeline stage has no whole forward: use loss()")

    def loss(self, tokens, labels, pos):
        """This rank's share of the mean next-token CE over every
        microbatch's positions with label >= 0 (the last stage's CE sum
        over the count of all positions; 0 on the other stages): the shares
        summed over pp x dp x cp are ``MagiLlama.loss`` of the whole
        batch."""
        from ..comm.primitives import ring_shift
        from ..utils.instrument import named_scope

        if tokens.dim() != 2:
            raise ValueError("MagiLlamaPP.loss takes [microbatches, tokens] rows")
        nm, t = tokens.shape
        pos = pos.expand(nm, -1) if pos.dim() == 1 else pos
        dt, s, last = self.cfg.torch_dtype, self.stage, self.pp - 1
        # the chain's start: what a stage holds before the first shift
        x_in = torch.zeros((t, self.cfg.dim), dtype=dt, device=self.embed.device,
                           requires_grad=True)
        loss_sum = torch.zeros((), device=self.embed.device)
        count = torch.zeros((), device=self.embed.device)
        self.ticks = 0
        for m in range(nm + self.pp - 1):
            self.ticks += 1
            j = m - s  # the microbatch at this stage this tick
            if 0 <= j < nm:
                x = (_Tie.apply(self.embed.to(dt)[tokens[j]], x_in) if s == 0 else x_in)
                y = self._run_layers(x, pos[j])
                if s == last:
                    ls, cnt = masked_ce_sums(self._head(y), labels[j])
                    loss_sum, count = loss_sum + ls, count + cnt
            else:  # a bubble: nothing to compute
                y = _Tie.apply(torch.zeros_like(x_in), x_in)
            if self.pp_group is None:
                x_in = y
            else:
                with named_scope("magi_pp_boundary_ppermute"):
                    x_in = ring_shift(y, self.pp_group)
        with named_scope("magi_pp_loss_psum"):
            count = _sum_over(count, self.sum_groups)
        share = loss_sum / torch.clamp(count, min=1.0)
        return _Tie.apply(share, x_in)


def build_magi_llama_pp(
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
    chunk_size: int | None = None,
    overlap_config=None,
    groups: ParallelGroups | None = None,
) -> MagiLlamaPP:
    """Plan the attention for one mask and bundle this rank's pipeline
    stage: the counterpart of the JAX ``build_magi_llama_pp``. The groups
    come as one ``make_parallel_groups`` result (``groups``; None: one
    rank); ``pp`` must divide ``n_layers`` and tp both head counts
    (``ValueError`` otherwise, as JAX). ``params`` is the full layer-stacked tree
    (:func:`init_pp_params`, or JAX's through ``convert``), or a list tree
    (:func:`init_params`); without it the weights are drawn from ``seed``
    on ``device`` as ``init_params`` draws them. The rank keeps its stage's
    layers, cut to its tp slices; the rest is ``build_magi_llama``'s."""
    import torch.distributed as dist

    device = torch.device(device)
    lay = _layout(groups)
    pp = 1 if lay["pp"] is None else dist.get_world_size(lay["pp"])
    if cfg.n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")
    meta, hb, cp = _plan(cfg, total_seqlen, q_ranges, k_ranges, attn_type_map, lay,
                         block_q=block_q, block_k=block_k, device=device, chunk_size=chunk_size,
                         overlap_config=overlap_config, who="build_magi_llama_pp")
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    stage = 0 if lay["pp"] is None else dist.get_rank(lay["pp"])
    per = cfg.n_layers // pp
    rows = slice(stage * per, (stage + 1) * per)
    layers = params["layers"]
    if isinstance(layers, dict):  # stacked: this stage's rows
        layers = [{n: layers[n][i] for n in LAYER_KEYS} for i in range(rows.start, rows.stop)]
    else:
        layers = layers[rows]
    params = _place_params(cfg, {**params, "layers": layers}, seed, device, lay["tp"])
    return MagiLlamaPP(cfg, meta, params, head_block=hb, pp_group=lay["pp"], stage=stage, pp=pp,
                       layer_sum_groups=lay["dpcp"], dp_group=lay["dp"], tp_group=lay["tp"],
                       sum_groups=lay["ppdpcp"], **cp)
