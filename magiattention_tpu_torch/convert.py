"""State to and from numpy arrays.

The attention library has no weights of its own: its state is the paged KV
cache (``k_pages``, ``v_pages``, ``block_tables``, ``seq_lens``) and the
kernel plan (the arrays of a ``FlexAttnBlockMeta``); the Llama trainer adds
its parameter tree. These functions carry that state across as numpy
arrays, so that the JAX package and the port can be handed the same state
and compute the same thing — numpy is the only common currency; this module
imports nothing of JAX.

bfloat16 arrays from JAX come as numpy arrays of the ``bfloat16`` extension
dtype; they are read through their 16-bit pattern, with no conversion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.llama import LAYER_KEYS, TP_COLUMNS, TP_ROWS
from .ops.block_meta import FlexAttnBlockMeta
from .serving.kv_cache import PagedKVCache


def tensor_from_numpy(a, device: str | torch.device = "cpu", dtype: torch.dtype | None = None):
    """A tensor copy of a numpy array (bfloat16 arrays by bit pattern),
    optionally cast to ``dtype``, on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor; bfloat16 is widened to float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def cache_from_numpy(
    k_pages,
    v_pages,
    block_tables,
    seq_lens,
    *,
    device: str | torch.device = "cpu",
    dtype: torch.dtype | None = None,
) -> PagedKVCache:
    """A :class:`PagedKVCache` holding copies of the four arrays (e.g. the
    fields of a JAX ``PagedKVCache`` through ``np.asarray``); pages are cast
    to ``dtype`` when given."""
    return PagedKVCache(
        k_pages=tensor_from_numpy(k_pages, device, dtype),
        v_pages=tensor_from_numpy(v_pages, device, dtype),
        block_tables=tensor_from_numpy(block_tables, device, torch.int32),
        seq_lens=tensor_from_numpy(seq_lens, device, torch.int32),
    )


def cache_to_numpy(cache: PagedKVCache) -> dict[str, np.ndarray]:
    """The cache's four arrays as numpy, keyed by field name."""
    return {
        f.name: tensor_to_numpy(getattr(cache, f.name))
        for f in dataclasses.fields(cache)
    }


def block_meta_from_numpy(meta) -> FlexAttnBlockMeta:
    """The port's plan from any object (or dict) with a ``FlexAttnBlockMeta``'s
    fields — such as the JAX package's plan of the same name. Arrays are
    copied as int32; scalars as ints."""
    get = meta.get if isinstance(meta, dict) else lambda name: getattr(meta, name)
    values = {}
    for f in dataclasses.fields(FlexAttnBlockMeta):
        v = get(f.name)
        if isinstance(v, (np.ndarray, list, tuple)):
            values[f.name] = np.ascontiguousarray(np.asarray(v), dtype=np.int32)
        else:
            values[f.name] = int(v)
    return FlexAttnBlockMeta(**values)


def block_meta_to_numpy(meta: FlexAttnBlockMeta) -> dict:
    """The plan's fields as a dict (numpy arrays and ints)."""
    return {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)}


def llama_params_from_numpy(tree, device: str | torch.device = "cpu") -> dict:
    """The port's Llama parameter tree from the JAX package's (its
    ``init_params(PRNGKey, cfg)``, or the layer-stacked tree of
    ``init_pp_params``, through ``np.asarray``): float32 tensors on
    ``device``, for ``models.build_magi_llama(params=...)`` (or
    ``build_magi_llama_pp``). The weight layout stays the JAX one, ``[in,
    out]`` applied as ``x @ w``, so every array carries across unchanged.
    The tree stays whole: the builders cut a tensor-parallel rank's slices
    themselves (``models.llama.shard_llama_params``)."""

    def conv(a):
        return tensor_from_numpy(a, device, torch.float32)

    layers = tree["layers"]
    return {
        "embed": conv(tree["embed"]),
        "layers": ({n: conv(layers[n]) for n in LAYER_KEYS} if isinstance(layers, dict)
                   else [{n: conv(layer[n]) for n in LAYER_KEYS} for layer in layers]),
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


def _gathered(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated on ``axis`` (``t``
    itself without a group)."""
    if group is None:
        return t
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def llama_params_to_numpy(model, *, grad: bool = False) -> dict:
    """A ``MagiLlama``'s parameters (or, with ``grad``, their gradients; a
    gradient never computed reads 0) as numpy arrays in the JAX package's
    tree. Under tp the layer slices are gathered back over the model's tp
    group, and a pipeline model's stage layers over its pp group into the
    layer-stacked tree of JAX's ``MagiLlamaPP``: then every rank of those
    groups calls this together."""
    tree = model.param_tree()
    tp_group = getattr(model, "tp_group", None)
    pp_group = getattr(model, "pp_group", None)
    stacked = getattr(model, "stacked", False)

    def leaf(p):
        t = p.grad if grad else p
        return (torch.zeros_like(p) if t is None else t).detach()

    def layer_leaf(name, ts):
        t = torch.stack(ts) if stacked else ts
        if name in TP_COLUMNS:
            t = _gathered(t, tp_group, -1)
        elif name in TP_ROWS:
            t = _gathered(t, tp_group, -2)
        if stacked:
            t = _gathered(t, pp_group, 0)
        return tensor_to_numpy(t)

    if stacked:
        layers = {n: layer_leaf(n, [leaf(layer[n]) for layer in tree["layers"]])
                  for n in LAYER_KEYS}
    else:
        layers = [{n: layer_leaf(n, leaf(layer[n])) for n in LAYER_KEYS}
                  for layer in tree["layers"]]
    return {
        "embed": tensor_to_numpy(leaf(tree["embed"])),
        "layers": layers,
        "final_norm": tensor_to_numpy(leaf(tree["final_norm"])),
        "lm_head": tensor_to_numpy(leaf(tree["lm_head"])),
    }
