"""Rank-side functions of the port's multi-rank tests, run through
``magiattention_tpu_torch.testing.dist.RankPool``. This module imports the
port and torch only: the ranks import no JAX."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


def keyed_attention(group, case: dict, inputs: dict) -> dict:
    """``magi_attn_flex_key`` -> ``dispatch`` -> ``calc_attn`` ->
    ``undispatch`` on the CPU (float32, or ``case["dtype"]``), forward and
    backward of sum(out * g_out) + sum(lse * g_lse) over the covered rows.
    Returns the global out, lse and the gradients (rank 0's; every rank
    holds them) and the dtypes the cast's backward reduced in.
    ``case["high_precision_backward"]`` sets
    ``MAGI_ATTENTION_BACKWARD_HIGH_PRECISION_REDUCE`` for this call;
    ``case["skip_reduce"]`` plants a cast whose backward drops the dK/dV of
    received rows (left in place: the caller replaces the pool).
    ``case["hier"]`` = (n_inter, n_intra) makes the key over
    ``make_hier_cp_groups`` (hierarchical comm), ``case["hier_plant"]``
    plants a faulty hierarchical reduce (``plant_hier_reduce``) for this
    call, and ``case["new_mask"]`` = (q_ranges, k_ranges, types) runs the
    attention on ``make_flex_key_for_new_mask_after_dispatch``'s key for
    that mask over the first key's dispatch. ``case["env"]`` holds more
    flags to set for this call (``{name: value}``)."""
    from magiattention_tpu_torch.comm import group_collective as gc

    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = case["impl"]
    os.environ.update(case.get("env", {}))
    restore = plant_hier_reduce(case["hier_plant"]) if case.get("hier_plant") else None
    if case.get("high_precision_backward"):
        os.environ["MAGI_ATTENTION_BACKWARD_HIGH_PRECISION_REDUCE"] = "1"
    if case.get("skip_reduce"):
        gc.GroupCast.backward = staticmethod(
            lambda ctx, g: (g.new_zeros((ctx.rt.num_local_rows,) + tuple(g.shape[1:])), None, None))
    reduce_dtypes = set()
    real_reduce = gc.cast_transpose  # the cast's backward: the dK/dV reduce

    def recording_reduce(y, rt, grp):
        reduce_dtypes.add(str(y.dtype))
        return real_reduce(y, rt, grp)

    gc.cast_transpose = recording_reduce
    try:
        return {**_keyed_attention(group, case, inputs), "reduce_dtypes": sorted(reduce_dtypes)}
    finally:
        gc.cast_transpose = real_reduce
        os.environ.pop("MAGI_ATTENTION_BACKWARD_HIGH_PRECISION_REDUCE", None)
        for name in case.get("env", {}):
            os.environ.pop(name)
        if restore is not None:
            restore()


def _keyed_attention(group, case: dict, inputs: dict) -> dict:
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.dispatch_solver import DispatchConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig

    dtype = getattr(torch, case.get("dtype", "float32"))
    q, k, v = (torch.from_numpy(inputs[n]).to(dtype).requires_grad_() for n in ("q", "k", "v"))
    sink = inputs.get("sink")
    sink = None if sink is None else torch.from_numpy(sink).requires_grad_()
    cp_group = group
    if case.get("hier"):
        from magiattention_tpu_torch.comm import make_hier_cp_groups

        cp_group = make_hier_cp_groups(group, *case["hier"])
    key = api.magi_attn_flex_key(
        case["q_ranges"], case["k_ranges"], case["types"], case["total"], case["total"],
        cp_group, num_heads=(q.shape[1], k.shape[1]), head_dim=q.shape[2],
        chunk_size=case["chunk"], sink=sink, out_dtype=dtype, device="cpu",
        dist_attn_config=DistAttnConfig(
            dispatch_config=DispatchConfig(uneven_shard=case.get("uneven", False)),
            overlap_config=OverlapConfig(degree=case["degree"],
                                         min_stage_rows=case["min_stage_rows"])),
    )
    if case.get("new_mask"):
        key = api.make_flex_key_for_new_mask_after_dispatch(*case["new_mask"], key)
    mgr = api.get_runtime_mgr(key)
    out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key), api.dispatch(v, key),
                                key, sink=sink)
    out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
    finite = torch.isfinite(lse)
    g_out, g_lse = torch.from_numpy(inputs["g_out"]), torch.from_numpy(inputs["g_lse"])
    loss = (out.float() * g_out).sum() + torch.where(finite, lse * g_lse, 0.0).sum()
    loss.backward()
    res = {
        "out": out.detach().float().numpy(), "lse": lse.detach().numpy(),
        "dq": q.grad.float().numpy(), "dk": k.grad.float().numpy(),
        "dv": v.grad.float().numpy(),
        "degree": mgr.plan.overlap_degree, "impls": [c.impl for c in mgr.plan.comms()],
        "max_logits": meta.max_logits.numpy(), "partitions": mgr.dispatch_meta.partitions,
        "hier": mgr.plan.hier, "key_hier": key.hier, "key_q_ranges": key.q_ranges,
        "key_k_ranges": key.k_ranges, "key_types": key.attn_type_map,
    }
    if case.get("return_plan") and dist.get_rank(group) == 0:
        res["plan"] = mgr.plan
    if sink is not None:
        res["dsink"] = sink.grad.numpy()
    return res


def llama_cp(group, fields: dict, total: int, cu: list, chunk: int, params: dict,
             tokens: np.ndarray, labels: np.ndarray, degree: int, impl: str, steps: int,
             adamw: dict, hier: tuple | None = None) -> dict:
    """The port's Llama under cp on the CPU: this rank's share of the loss,
    the gradients summed over the group, then ``steps`` AdamW steps of
    ``make_model_train_step``. Returns the loss, the gradients (numpy, the
    ``init_params`` tree) and the steps' losses. ``hier`` = (n_inter,
    n_intra) builds the model over ``make_hier_cp_groups`` (hierarchical
    comm)."""
    from magiattention_tpu_torch import convert
    from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.models import (
        LlamaConfig,
        build_magi_llama,
        make_model_train_step,
    )
    from magiattention_tpu_torch.models._common import sum_grads

    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = impl
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(cu)
    cp_group = group
    if hier:
        from magiattention_tpu_torch.comm import make_hier_cp_groups

        cp_group = make_hier_cp_groups(group, *hier)
    model = build_magi_llama(
        LlamaConfig(**fields), total, qr, kr, ts, params=convert.llama_params_from_numpy(params),
        device="cpu", cp_group=cp_group, chunk_size=chunk,
        overlap_config=OverlapConfig(degree=degree, min_stage_rows=chunk),
    )
    tok, lab = (model.shard(torch.from_numpy(a).long()) for a in (tokens, labels))
    pos = model.position_ids().expand(tok.shape[0], -1)
    share = model.loss(tok, lab, pos)
    share.backward()
    for params_, grp in model.grad_groups():
        sum_grads(params_, grp)
    loss = share.detach().clone()
    dist.all_reduce(loss, group=group)
    grads = convert.llama_params_to_numpy(model, grad=True)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **adamw))
    losses = [float(step(tok, lab, pos)) for _ in range(steps)]
    return {"loss": float(loss), "grads": grads, "losses": losses,
            "degree": model.plan.overlap_degree, "head_block": model.head_block,
            "impls": [c.impl for c in model.plan.comms()], "hier": model.plan.hier}


def llama_parallel(group, fields: dict, total: int, cu: list, chunk: int, params: dict,
                   tokens: np.ndarray, labels: np.ndarray, layout: dict, steps: int,
                   adamw: dict, block: int = 64, remat: bool = False) -> dict:
    """The port's Llama trainer under a (pp, dp, cp, tp) layout on the CPU
    (``make_parallel_groups(**layout)``; ``build_magi_llama_pp`` when pp >
    1): this rank's loss share summed over the layout's loss groups, the
    first backward's gradients summed as the train step sums them and
    gathered back to the full tree (layer-stacked under pp), then ``steps``
    AdamW steps of ``make_model_train_step``."""
    from magiattention_tpu_torch import convert
    from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
    from magiattention_tpu_torch.models import (
        LlamaConfig,
        build_magi_llama,
        build_magi_llama_pp,
        make_model_train_step,
        make_parallel_groups,
    )
    from magiattention_tpu_torch.models._common import sum_grads

    qr, kr, ts = infer_attn_mask_from_cu_seqlens(cu)
    groups = make_parallel_groups(**layout)
    cfg = LlamaConfig(**fields, remat=remat)
    build = build_magi_llama_pp if layout.get("pp", 1) > 1 else build_magi_llama
    model = build(cfg, total, qr, kr, ts, params=convert.llama_params_from_numpy(params),
                  device="cpu", groups=groups, chunk_size=chunk if groups.cp is not None else None,
                  block_q=block, block_k=block)
    tok, lab = (model.shard(torch.from_numpy(a).long()) for a in (tokens, labels))
    pos = model.position_ids().expand(tok.shape[0], -1)
    share = model.loss(tok, lab, pos)
    share.backward()
    for params_, grp in model.grad_groups():
        sum_grads(params_, grp)
    loss = share.detach().clone()
    for grp in model.sum_groups:
        dist.all_reduce(loss, group=grp)
    grads = convert.llama_params_to_numpy(model, grad=True)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **adamw))
    losses = [float(step(tok, lab, pos)) for _ in range(steps)]
    return {"loss": float(loss), "grads": grads, "losses": losses, "coords": groups.coords,
            "ticks": getattr(model, "ticks", None), "head_block": model.head_block, "heads": (model.layers[0].wq.shape[1],
                                                      model.layers[0].wk.shape[1]),
            "hier": None if model.plan is None else model.plan.hier}


def llama_pp_refusal(group, fields: dict, total: int, cu: list, chunk: int) -> str:
    """``build_magi_llama_pp`` over pp2 x cp2 for a config whose layers do
    not split over pp: the error's message."""
    from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
    from magiattention_tpu_torch.models import (
        LlamaConfig,
        build_magi_llama_pp,
        make_parallel_groups,
    )

    groups = make_parallel_groups(pp=2, cp=2)
    try:
        build_magi_llama_pp(LlamaConfig(**fields), total, *infer_attn_mask_from_cu_seqlens(cu),
                            device="cpu", groups=groups, chunk_size=chunk)
    except ValueError as exc:
        return str(exc)
    return "built"


def baseline_attn(group, kind: str, case: dict, inputs: dict) -> dict:
    """One of the port's cp baselines on the CPU (float32): this rank's
    shard of the global q, k, v (contiguous, or zigzag for ``hybrid_dcp``),
    ``make_*_attn_fn``'s forward, and the backward of sum(out * g_out) +
    sum(lse * g_lse); the out, lse and gradients gathered back to global
    order (every rank returns them), and rank 0's host tables.
    ``usp_nsa`` is forward only. ``case``: total, slices [S, 5], the
    layout (``cp``, or ``outer`` x ``inner``)."""
    from magiattention_tpu_torch.comm import make_hier_cp_groups
    from magiattention_tpu_torch.comm.primitives import all_gather_tiled
    from magiattention_tpu_torch.ops.flex_attn import FlexAttnParams
    from magiattention_tpu_torch.parallel import baselines as bl

    total, slices = case["total"], np.asarray(case["slices"], np.int64)
    cp, rank = dist.get_world_size(group), dist.get_rank(group)
    q, k, v, g_out, g_lse = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v", "g_out",
                                                                    "g_lse"))
    d = q.shape[-1]
    params = FlexAttnParams(block_q=64, block_k=64, scale=1.0 / float(np.sqrt(d)), softcap=0.0,
                            has_sink=False, out_dtype=torch.float32)
    qr, kr, ty = slices[:, :2], slices[:, 2:4], slices[:, 4]
    zig = kind == "hybrid_dcp"

    def order(x):
        return bl.zigzag_dispatch(x, total, cp) if zig else x

    def unorder(x):
        return bl.zigzag_undispatch(x, total, cp) if zig else x

    if kind == "ring":
        plan = bl.build_ring_attn_plan(slices, total, cp, block_q=64, block_k=64)
        fn, tables = bl.make_ring_attn_fn(plan, group, params), plan.steps
    elif kind == "ulysses":
        plan = bl.build_ulysses_plan(qr, kr, ty, total, cp, block_q=64, block_k=64)
        fn, tables = bl.make_ulysses_attn_fn(plan, group, params), plan.meta
    elif kind == "usp":
        groups = make_hier_cp_groups(group, case["outer"], case["inner"])  # (ring, ulysses)
        plan = bl.build_usp_plan(slices, total, case["inner"], case["outer"], block_q=64,
                                 block_k=64)
        fn, tables = bl.make_usp_attn_fn(plan, groups, params), plan.ring_plan.steps
    elif kind == "double_ring":
        groups = make_hier_cp_groups(group, case["outer"], case["inner"])
        plan = bl.build_double_ring_plan(slices, total, case["outer"], case["inner"],
                                         block_q=64, block_k=64)
        fn, tables = bl.make_double_ring_attn_fn(plan, groups, params), plan.steps
    elif kind == "hybrid_dcp":
        plan = bl.build_hybrid_dcp_plan(slices, total, cp, block_q=64, block_k=64)
        fn, tables = bl.make_hybrid_dcp_attn_fn(plan, group, params), plan.tables
    elif kind == "usp_nsa":
        fn, tables = bl.make_usp_nsa_attn_fn(total, group, bl.NsaConfig(**case["nsa"])), None
    else:
        raise ValueError(kind)
    shard = total // cp
    rows = slice(rank * shard, (rank + 1) * shard)
    qs, ks, vs = (order(x)[rows].clone().requires_grad_() for x in (q, k, v))

    def gather(x):
        return unorder(all_gather_tiled(x.detach().contiguous(), group)).numpy()

    if kind == "usp_nsa":
        return {"out": gather(fn(qs, ks, vs))}
    out, lse = fn(qs, ks, vs)
    loss = (out * order(g_out)[rows]).sum() + (lse * order(g_lse)[rows]).sum()
    loss.backward()
    res = {"out": gather(out), "lse": gather(lse), "dq": gather(qs.grad), "dk": gather(ks.grad),
           "dv": gather(vs.grad)}
    if rank == 0:
        res["tables"] = tables
    return res


def comm_primitives(group, impl: str, seed: int) -> dict:
    """The comm layer on its own: ``all_gather_v`` / ``scatter_v`` /
    ``all2all_v`` on uneven sizes, ``replicated``'s summed gradient, and a
    random send map's ``group_cast`` with ``group_reduce_sum`` (its
    transpose: <cast(x), y> = <x, reduce(y)> on every rank's rows)."""
    from magiattention_tpu_torch.comm import (
        GroupCollectiveMeta,
        all2all_v,
        all_gather_v,
        group_cast,
        group_reduce_sum,
        rank_routing,
        replicated,
        scatter_v,
    )

    cp, rank = dist.get_world_size(group), dist.get_rank(group)
    sizes = [3 + 2 * r for r in range(cp)]
    x = torch.full((max(sizes), 2), float(rank))
    gathered = all_gather_v(x, sizes, group)
    scattered = scatter_v(torch.arange(sum(sizes), dtype=torch.float32), sizes, group)
    send = torch.arange(cp * 4, dtype=torch.float32).view(cp, 4) + 100 * rank
    recv = all2all_v(send, [[4] * cp for _ in range(cp)], group)
    s = torch.ones(3, requires_grad=True)
    (replicated(s, group) * (rank + 1)).sum().backward()

    rng = np.random.default_rng(seed)  # the same map on every rank
    rows = 40
    send_map = [[np.sort(rng.choice(rows, int(rng.integers(0, 12)), replace=False))
                 if src != dst else np.empty(0, np.int64) for dst in range(cp)]
                for src in range(cp)]
    meta = GroupCollectiveMeta.build(send_map, [rows] * cp, impl=impl)
    rt = rank_routing(meta, rank, rows, "cpu")
    xs = torch.from_numpy(np.random.default_rng(seed + rank).standard_normal((rows, 3)))
    ys = torch.from_numpy(np.random.default_rng(seed + 10 + rank).standard_normal(
        (meta.max_recv, 3)))
    cast = group_cast(xs, rt, group)
    red = group_reduce_sum(ys, rt, group)
    expect = [xs_row for src in range(cp) for xs_row in send_map[src][rank]]
    lhs = torch.tensor([float((cast * ys).sum())], dtype=torch.float64)
    rhs = torch.tensor([float((xs * red).sum())], dtype=torch.float64)
    dist.all_reduce(lhs, group=group)
    dist.all_reduce(rhs, group=group)
    return {"gathered": gathered.numpy(), "scattered": scattered.numpy(), "a2a": recv.numpy(),
            "sink_grad": s.grad.numpy(), "impl": meta.impl, "n_recv": len(expect),
            "cast_tail_zero": bool((cast[meta.recv_total[rank]:] == 0).all()),
            "adjoint": (float(lhs), float(rhs))}


def _drop_remote_partials(gc):
    """A planted fault in the O-return reduce: every partial row that comes
    back from another rank arrives as (0, -inf), as if it had been lost.
    Returns the real ``return_rows`` (the caller puts it back)."""
    real = gc.return_rows

    def dropping(y, rt, group, fill=0.0):
        parts = real(y, rt, group, fill)
        if rt.impl == "hops":
            remote = [torch.full((rows.shape[0],), bool(h.shift % rt.cp_size))
                      for h, (rows, _) in zip(rt.hops, parts)]
        else:  # a2a: block i of the returned buffer came from rank i
            remote = [(rt.back_pos // rt.max_send) != rt.rank]
        return [(torch.where(m.view((-1,) + (1,) * (rows.ndim - 1)), torch.full_like(rows, fill),
                             rows), seg) for (rows, seg), m in zip(parts, remote)]

    gc.return_rows = dropping
    return real


def _solver(kind):
    from magiattention_tpu_torch import meta

    return {"kd": meta.DynamicAttnSolver, "ncq": meta.NCQDynamicSolver,
            "grid": meta.GridLocalitySolver, "snf": meta.SNFDynamicSolver,
            "auto": meta.AutoDynamicSolver}[kind]()


def qo_attention(group, case: dict, inputs: dict) -> dict:
    """qo-comm on the CPU in float32, forward and backward of sum(out *
    g_out) + sum(lse * g_lse) over the covered rows; returns the global
    out, lse and gradients (every rank holds them) and the plan's facts.

    ``case["keyed"]``: the keyed API under ``MAGI_ATTENTION_QO_COMM=1``
    (``dispatch`` -> ``calc_attn`` -> ``undispatch``, the auto solver over
    the MinHeap dispatch). Else ``qo_comm_attn_local`` on the contiguous
    shard of a plan built with ``case["solver"]`` (and
    ``case["dispatch_meta"]``'s ownership when set), the gradients summed
    over the ranks. ``case["drop_remote"]`` plants an O-return reduce that
    drops every remote partial."""
    from magiattention_tpu_torch.comm import group_collective as gc

    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = case["impl"]
    real = _drop_remote_partials(gc) if case.get("drop_remote") else None
    try:
        return (_qo_keyed if case.get("keyed") else _qo_local)(group, case, inputs)
    finally:
        if real is not None:
            gc.return_rows = real
        os.environ.pop("MAGI_ATTENTION_QO_COMM", None)


def _loss(out, lse, inputs, rows=slice(None)):
    g_out = torch.from_numpy(inputs["g_out"])[rows]
    g_lse = torch.from_numpy(inputs["g_lse"])[rows]
    return (out * g_out).sum() + torch.where(torch.isfinite(lse), lse * g_lse, 0.0).sum()


def _qo_facts(plan) -> dict:
    return {"impls": [plan.comm_q.impl, plan.comm_kv.impl],
            "q_remote_rows": plan.comm_q.true_rows_total - plan.comm_q.local_rows_total,
            "rank_areas": list(plan.rank_areas)}


def _qo_keyed(group, case, inputs):
    from magiattention_tpu_torch import api

    os.environ["MAGI_ATTENTION_QO_COMM"] = "1"
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_() for n in ("q", "k", "v"))
    sink = inputs.get("sink")
    sink = None if sink is None else torch.from_numpy(sink).requires_grad_()
    key = api.magi_attn_flex_key(
        case["q_ranges"], case["k_ranges"], case["types"], case["total"], case["total"], group,
        num_heads=(q.shape[1], k.shape[1]), head_dim=q.shape[2], chunk_size=case["chunk"],
        sink=sink, out_dtype=torch.float32, device="cpu")
    os.environ.pop("MAGI_ATTENTION_QO_COMM")
    kv_key = api.magi_attn_flex_key(
        case["q_ranges"], case["k_ranges"], case["types"], case["total"], case["total"], group,
        num_heads=(q.shape[1], k.shape[1]), head_dim=q.shape[2], chunk_size=case["chunk"],
        sink=sink, out_dtype=torch.float32, device="cpu")
    mgr = api.get_runtime_mgr(key)
    out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key), api.dispatch(v, key),
                                key, sink=sink)
    out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
    _loss(out, lse, inputs).backward()
    res = {"out": out.detach().numpy(), "lse": lse.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy(), "plan": type(mgr.plan).__name__,
           "kv_plan": type(api.get_runtime_mgr(kv_key).plan).__name__,
           "keys_differ": key != kv_key, "max_logits": meta.max_logits,
           "partitions": mgr.dispatch_meta.partitions, **_qo_facts(mgr.plan)}
    if sink is not None:
        res["dsink"] = sink.grad.numpy()
    return res


def _qo_local(group, case, inputs):
    from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu_torch.parallel import (
        build_qo_comm_plan,
        dispatch,
        make_attn_params,
        qo_comm_attn_local,
        undispatch,
    )

    cp, rank, total = dist.get_world_size(group), dist.get_rank(group), case["total"]
    slices = np.asarray([(*qr, *kr, t) for qr, kr, t in
                         zip(case["q_ranges"], case["k_ranges"], case["types"])], np.int64)
    mq = None
    if case.get("dispatch_chunk"):
        from magiattention_tpu_torch.common import AttnMaskType, AttnRanges

        mq, _, _ = make_dispatch_meta_from_qk_ranges(
            AttnRanges.from_ranges(case["q_ranges"]), AttnRanges.from_ranges(case["k_ranges"]),
            [AttnMaskType(t) for t in case["types"]], total, total, case["dispatch_chunk"], cp)
    plan = build_qo_comm_plan(slices, total, cp, block_q=64, block_k=64,
                              solver=_solver(case["solver"]), dispatch_meta=mq)
    params = make_attn_params(plan, inputs["q"].shape[2], out_dtype=torch.float32)
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_() for n in ("q", "k", "v"))
    sink = inputs.get("sink")
    sink = None if sink is None else torch.from_numpy(sink).requires_grad_()
    n = plan.shard_len
    grads_local = mq is None  # each rank's backward then gives its own rows' gradients only
    if grads_local:
        shard = lambda x: x[rank * n:(rank + 1) * n]  # noqa: E731
        out_l, lse_l = qo_comm_attn_local(shard(q), shard(k), shard(v), plan, params, group,
                                          sink=sink)
        outs = [torch.empty_like(out_l) for _ in range(cp)]
        lses = [torch.empty_like(lse_l) for _ in range(cp)]
        dist.all_gather(outs, out_l.detach(), group=group)
        dist.all_gather(lses, lse_l.detach(), group=group)
        out, lse = torch.cat(outs), torch.cat(lses)
        _loss(out_l, lse_l, inputs, slice(rank * n, (rank + 1) * n)).backward()
    else:  # dispatch's backward gathers the shards' gradients; the sink's is summed
        from magiattention_tpu_torch.comm import replicated

        out_l, lse_l = qo_comm_attn_local(
            *(dispatch(x, mq, group) for x in (q, k, v)), plan, params, group,
            sink=None if sink is None else replicated(sink, group))
        out, lse = undispatch(out_l, mq, group), undispatch(lse_l, mq, group)
        _loss(out, lse, inputs).backward()
        out, lse = out.detach(), lse.detach()
    grads = {"dq": q.grad, "dk": k.grad, "dv": v.grad}
    if sink is not None:
        grads["dsink"] = sink.grad
    if grads_local:
        for g in grads.values():
            dist.all_reduce(g, group=group)
    return {"out": out.numpy(), "lse": lse.numpy(), **{n: g.numpy() for n, g in grads.items()},
            **_qo_facts(plan)}


def reduce_lse(group, impl: str, ops: dict, send_map, rows: int) -> dict:
    """``group_reduce_lse`` on its own: this rank's row of the stacked
    partials and accumulators in ``ops``, the reduce over ``send_map``'s
    routing and the gradients of sum(out**2) + sum(lse) over the finite
    lse entries, for every input. ``ops["drop_remote"]`` plants the reduce
    that drops the partials of other ranks."""
    from magiattention_tpu_torch.comm import GroupCollectiveMeta, rank_routing
    from magiattention_tpu_torch.comm import group_collective as gc

    rank = dist.get_rank(group)
    meta = GroupCollectiveMeta.build(send_map, [rows] * len(send_map), impl=impl)
    rt = rank_routing(meta, rank, rows, "cpu")
    xs = [torch.from_numpy(ops[n][rank]).requires_grad_() for n in ("op", "lp", "oa", "la")]
    real = _drop_remote_partials(gc) if ops.get("drop_remote") else None
    try:
        out, lse = gc.group_reduce_lse(*xs, rt, group)
    finally:
        if real is not None:
            gc.return_rows = real
    ((out ** 2).sum() + torch.where(torch.isfinite(lse), lse, 0.0).sum()).backward()
    return {"out": out.detach().numpy(), "lse": lse.detach().numpy(), "impl": meta.impl,
            **{f"d{n}": x.grad.numpy() for n, x in zip(("op", "lp", "oa", "la"), xs)}}


# -- hierarchical comm, cross-attention keys, new-mask keys and roll ------------------------


def plant_hier_reduce(kind: str):
    """The planted faults of the hierarchical reduce that ``chip_smoke.py``
    plants on the card (``chip_smoke.plant_hier_reduce``: ``"pad_rows"``,
    ``"no_pre_reduce"``), so that the CPU tests hold the same plants.
    Returns a function that puts the real reduce back."""
    import chip_smoke

    return chip_smoke.plant_hier_reduce(kind)


def hier_send_map(n: int, rows: int, seed: int):
    """A random send map over n ranks (the same on every rank)."""
    rng = np.random.default_rng(seed)
    return [[np.sort(rng.choice(rows, int(rng.integers(0, rows // 2)), replace=False))
             if s != d else np.empty(0, np.int64) for d in range(n)] for s in range(n)]


def hier_comm(group, n_inter: int, n_intra: int, impl: str, seed: int, rows: int,
              plant: str | None = None) -> dict:
    """``group_cast_hier`` and ``group_reduce_hier`` on a random send map
    over ``make_hier_cp_groups``: this rank's cast of its rows, its reduce
    of random partials (float64), the global inner products <cast(x), y>
    and <x, reduce(y)>, and ``GroupCastHier``'s gradient. ``plant`` swaps
    in a planted reduce (``plant_hier_reduce``)."""
    from magiattention_tpu_torch.comm import (
        GroupCastHier,
        HierGroupCollectiveMeta,
        group_cast_hier,
        hier_rank_routing,
        make_hier_cp_groups,
    )
    from magiattention_tpu_torch.comm import hier

    groups = make_hier_cp_groups(group, n_inter, n_intra)
    rank, n = dist.get_rank(group), n_inter * n_intra
    meta, _ = HierGroupCollectiveMeta.build(hier_send_map(n, rows, seed), [rows] * n, n_inter,
                                            n_intra, impl=impl)
    hr = hier_rank_routing(meta, rank, rows, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed + 1 + rank).standard_normal((rows, 3)))
    y = torch.from_numpy(np.random.default_rng(seed + 100 + rank).standard_normal(
        (meta.max_recv, 3)))
    restore = plant_hier_reduce(plant) if plant else None
    try:
        cast = group_cast_hier(x, hr, groups)
        red = hier.group_reduce_hier(y, hr, groups)
        xg = x.clone().requires_grad_()
        (GroupCastHier.apply(xg, hr, groups) * y).sum().backward()
    finally:
        if restore is not None:
            restore()
    sums = torch.tensor([float((cast * y).sum()), float((x * red).sum())], dtype=torch.float64)
    dist.all_reduce(sums, group=group)
    return {"impl": meta.impl, "cast": cast.numpy(), "reduce": red.numpy(), "x": x.numpy(),
            "y": y.numpy(), "grad": xg.grad.numpy(), "adjoint": sums.tolist(),
            "groups": (dist.get_world_size(groups.inter), dist.get_rank(groups.inter),
                       dist.get_world_size(groups.intra), dist.get_rank(groups.intra))}


def cross_attention(group, case: dict, inputs: dict) -> dict:
    """``magi_attn_cross_key`` -> ``dispatch`` (queries), ``dispatch_kv``
    (memory) -> ``calc_attn`` -> ``undispatch``, forward and backward of
    sum(out * g_out) + sum(lse * g_lse) over the covered rows, in float32 on
    the CPU. Returns the global out, lse and gradients, the plan (rank 0),
    the key's padding and ``get_xattn_args``, and ``undispatch_kv``'s round
    trip of the memory. ``case["skip_reduce"]`` plants a cast whose
    backward drops the memory's dK/dV (left in place: the caller replaces
    the pool)."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.comm import group_collective as gc
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig

    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = case["impl"]
    if case.get("skip_reduce"):
        gc.GroupCast.backward = staticmethod(
            lambda ctx, g: (g.new_zeros((ctx.rt.num_local_rows,) + tuple(g.shape[1:])), None, None))
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_() for n in ("q", "k", "v"))
    key = api.magi_attn_cross_key(
        case["q_ranges"], case["k_ranges"], case["types"], case["tq"], case["tk"], group,
        num_heads=(q.shape[1], k.shape[1]), head_dim=q.shape[2], chunk_size_q=case["chunk_q"],
        chunk_size_k=case["chunk_k"], out_dtype=torch.float32, device="cpu",
        overlap_config=OverlapConfig(degree=case["degree"], min_stage_rows=case["chunk_q"]))
    mgr = api.get_runtime_mgr(key)
    out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch_kv(k, key),
                                api.dispatch_kv(v, key), key)
    out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
    _loss(out, lse, inputs).backward()
    args = api.get_xattn_args(key)
    kv_round_trip = api.undispatch_kv(api.dispatch_kv(k.detach(), key), key)
    res = {"out": out.detach().numpy(), "lse": lse.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy(), "pad_size_k": mgr.pad_size_k,
           "pad_size": key.pad_size, "degree": mgr.plan.overlap_degree,
           "args": (args.total_seqlen_q, args.total_seqlen_k, args.shard_q_len, args.shard_k_len),
           "q_pos": args.q_position_ids.numpy(), "k_pos": args.k_position_ids.numpy(),
           "kv_round_trip_exact": bool(torch.equal(kv_round_trip, k.detach())),
           "max_logits": meta.max_logits.numpy()}
    if dist.get_rank(group) == 0:
        res["plan"] = mgr.plan
        res["q_partitions"] = mgr.dispatch_meta.partitions
        res["k_partitions"] = mgr.kv_dispatch_meta.partitions
    return res


def roll_labels(group, case: dict, shifts: list, labels: np.ndarray, x: np.ndarray,
                g: np.ndarray) -> dict:
    """``api.roll`` on this rank's dispatched integer labels for each shift
    (gathered back with ``undispatch``), and on a float tensor under
    autograd: the gathered roll of ``x`` by ``shifts[0]`` and the gradient
    of sum(roll(x) * g) with respect to the global ``x``."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.dispatch_solver import DispatchConfig

    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = case["impl"]
    cp_group = group
    if case.get("hier"):
        from magiattention_tpu_torch.comm import make_hier_cp_groups

        cp_group = make_hier_cp_groups(group, *case["hier"])
    key = api.magi_attn_flex_key(
        case["q_ranges"], case["k_ranges"], case["types"], case["total"], case["total"],
        cp_group, num_heads=(2, 2), head_dim=16, chunk_size=case["chunk"], device="cpu",
        dist_attn_config=DistAttnConfig(
            dispatch_config=DispatchConfig(uneven_shard=case.get("uneven", False))))
    lab = torch.from_numpy(labels)
    local = api.dispatch(lab, key, pad_value=-7)
    rolled = {}
    for shift in shifts:
        r = api.roll(local, key, shift)
        rolled[shift] = {"global": api.undispatch(r, key).numpy(), "local": r.numpy(),
                         "simple_equal": bool(torch.equal(api.roll_simple(local, key, shift), r))}
    xs = torch.from_numpy(x).requires_grad_()
    rx = api.undispatch(api.roll(api.dispatch(xs, key), key, shifts[0], axis=0), key)
    (rx * torch.from_numpy(g)).sum().backward()
    return {"rolled": rolled, "x_rolled": rx.detach().numpy(), "x_grad": xs.grad.numpy(),
            "partitions": api.get_runtime_mgr(key).dispatch_meta.partitions,
            "dispatched": local.numpy()}


def new_mask_key_origin(group, masks: dict, inputs: dict) -> dict:
    """Keys for the mask ``masks["w"]``: its own (planned first, so it is
    cached), and on the dispatches of masks ``"a"`` and ``"b"``, directly
    and through a key for ``"b"`` on ``"a"``'s dispatch. Returns which keys
    are equal, which runtimes and dispatch metas are shared, each
    dispatch's partitions, and the global out of a layer stack run as
    hybrid stacks run it (activations dispatched under ``"a"``'s key,
    attention on ``"w"``'s key over that dispatch) next to the out of
    ``"w"``'s own key."""
    from magiattention_tpu_torch import api

    def flex(mask):
        return api.magi_attn_flex_key(*mask, inputs["q"].shape[0], inputs["q"].shape[0], group,
                                      num_heads=(4, 2), head_dim=inputs["q"].shape[2],
                                      chunk_size=masks["chunk"], out_dtype=torch.float32,
                                      device="cpu")

    def out_of(attn_key, dispatch_key):
        q, k, v = (api.dispatch(torch.from_numpy(inputs[n]), dispatch_key) for n in "qkv")
        return api.undispatch(api.calc_attn(q, k, v, attn_key)[0], dispatch_key).numpy()

    new = api.make_flex_key_for_new_mask_after_dispatch
    mgr = api.get_runtime_mgr
    own = flex(masks["w"])
    ka, kb = flex(masks["a"]), flex(masks["b"])
    on_a, on_b = new(*masks["w"], ka), new(*masks["w"], kb)
    on_a_chained = new(*masks["w"], new(*masks["b"], ka))
    return {
        "own_vs_on_a_differ": own != on_a and mgr(own) is not mgr(on_a),
        "on_a_vs_on_b_differ": on_a != on_b and mgr(on_a) is not mgr(on_b),
        "chained_is_on_a": on_a_chained == on_a and mgr(on_a_chained) is mgr(on_a),
        "dispatch_inherited": mgr(on_a).dispatch_meta is mgr(ka).dispatch_meta
        and mgr(on_b).dispatch_meta is mgr(kb).dispatch_meta,
        "partitions": {n: mgr(k).dispatch_meta.partitions
                       for n, k in (("w", own), ("a", ka), ("b", kb))},
        "out_own": out_of(own, own), "out_on_a": out_of(on_a, ka), "out_on_b": out_of(on_b, kb),
    }


def key_variants(group) -> dict:
    """The keyed API's cache and refusals around the new key variants:
    cross keys whose memory totals pad to the same multiple stay apart;
    a flat and a hierarchical key on the same mask stay apart; the
    after-dispatch re-key refuses a sink key, a qo-comm key and a cross
    key, and inherits a hierarchical key's layout; ``get_xattn_args`` and
    ``dispatch_kv`` refuse a self-attention key. Returns the facts and
    the refusals' messages."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.comm import make_hier_cp_groups

    def cross(tk):
        return api.magi_attn_cross_key([(0, 256)], [(0, 512)], [0], 256, tk, group,
                                       num_heads=(2, 2), head_dim=16, chunk_size_q=64,
                                       chunk_size_k=128, out_dtype=torch.float32, device="cpu")

    def flex(cp_group, **kw):
        return api.magi_attn_flex_key([(0, 512)], [(0, 512)], [1], 512, 512, cp_group,
                                      num_heads=(2, 2), head_dim=16, chunk_size=64,
                                      out_dtype=torch.float32, device="cpu", **kw)

    def refusal(fn, *args):
        try:
            fn(*args)
        except ValueError as e:
            return str(e)
        return None

    k960, k1024, k960b = cross(960), cross(1024), cross(960)
    flat = flex(group)
    hier_groups = make_hier_cp_groups(group, 2, dist.get_world_size(group) // 2)
    hier = flex(hier_groups)
    new_hier = api.make_varlen_key_for_new_mask_after_dispatch([0, 256, 512], hier)
    sink = flex(group, sink=torch.zeros(2))
    os.environ["MAGI_ATTENTION_QO_COMM"] = "1"
    try:
        qo = flex(group)
    finally:
        os.environ.pop("MAGI_ATTENTION_QO_COMM")
    new = api.make_flex_key_for_new_mask_after_dispatch
    return {
        "cross_keys_differ": k960 != k1024, "cross_key_cached": k960 == k960b and
        api.get_runtime_mgr(k960) is api.get_runtime_mgr(k960b),
        "pad_size_k": (api.get_runtime_mgr(k960).pad_size_k,
                       api.get_runtime_mgr(k1024).pad_size_k),
        "is_cross": api.get_runtime_mgr(k960).is_cross_attn,
        "flat_hier_differ": flat != hier, "hier_key": hier.hier,
        "new_hier_plan": api.get_runtime_mgr(new_hier).plan.hier,
        "new_hier_key": new_hier.hier,
        "new_shares_dispatch": api.get_runtime_mgr(new_hier).dispatch_meta
        is api.get_runtime_mgr(hier).dispatch_meta,
        "refusals": {
            "sink": refusal(new, [(0, 512)], [(0, 512)], [0], sink),
            "qo": refusal(new, [(0, 512)], [(0, 512)], [0], qo),
            "cross": refusal(new, [(0, 256)], [(0, 512)], [0], k960),
            "xattn_args_self": refusal(api.get_xattn_args, flat),
            "dispatch_kv_self": refusal(api.dispatch_kv, torch.zeros(512, 2), flat),
        },
    }


def hier_flag_key(group) -> dict:
    """Under ``MAGI_ATTENTION_HIERARCHICAL_COMM=1``, a key over
    ``make_hier_cp_groups(group, 2, 2)`` plans the hierarchical comm; with
    the flag unset, a key over the flat group plans flat comm."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.comm import make_hier_cp_groups

    def key(cp_group):
        return api.magi_attn_flex_key([(0, 512)], [(0, 512)], [1], 512, 512, cp_group,
                                      num_heads=(2, 2), head_dim=16, chunk_size=64,
                                      out_dtype=torch.float32, device="cpu")

    os.environ["MAGI_ATTENTION_HIERARCHICAL_COMM"] = "1"
    try:
        k = key(make_hier_cp_groups(group, 2, 2))
    finally:
        os.environ.pop("MAGI_ATTENTION_HIERARCHICAL_COMM")
    return {"plan_hier": api.get_runtime_mgr(k).plan.hier, "key_hier": k.hier,
            "flat_plan_hier": api.get_runtime_mgr(key(group)).plan.hier}


def plan_reuse_stream(group, case: dict, requests: list, inputs: dict) -> dict:
    """Under ``MAGI_ATTENTION_PLAN_REUSE=bucket`` (set for this task only),
    each request's ``cu_seqlens`` through ``magi_attn_varlen_key`` (float32
    on the CPU) -> ``dispatch`` -> ``calc_attn`` -> ``undispatch``, forward
    and backward of sum(out * g_out) + sum(lse * g_lse) over the covered
    rows: per request its tier, the gathered out / lse / dq / dk / dv, the
    canonical total and, for a bucketed key, the three host tables (int32,
    over all ranks). Then ``magi_attn_varlen_dispatch``,
    ``magi_attn_flex_dispatch`` and ``init_dist_attn_runtime_mgr`` on
    request 0's mask (its key, its dispatch, its manager), the typed
    refusals of ``roll`` and both new-mask
    keys on a bucketed key, the tier of request 1 under
    ``MAGI_ATTENTION_QO_COMM`` (which opts out of reuse), and the sizes of both cache levels with a key
    of a second group over the same ranks planned, after ``clear_cache``
    of that group, and after ``clear_cache`` of this one."""
    from chip_smoke import key_tier
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api import interface

    os.environ["MAGI_ATTENTION_PLAN_REUSE"] = "bucket"
    api.clear_cache()
    try:
        res, keys = {}, {}
        for name, cu in requests:
            x = {n: torch.from_numpy(inputs[name][n]).requires_grad_() for n in ("q", "k", "v")}
            key, tier, _, patched = key_tier(interface, lambda: api.magi_attn_varlen_key(
                cu, cu[-1], group, num_heads=(x["q"].shape[1], x["k"].shape[1]),
                head_dim=x["q"].shape[2], chunk_size=case["chunk"], out_dtype=torch.float32,
                device="cpu"))
            keys[name] = key
            mgr = api.get_runtime_mgr(key)
            out_l, meta = api.calc_attn(*(api.dispatch(x[n], key) for n in "qkv"), key)
            out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
            loss = _loss(out, lse, inputs[name])
            loss.backward()
            r = {"tier": tier, "patched": patched, "most_recent_is_key":
                 api.get_most_recent_key() == key,
                 "bucketed": isinstance(mgr, api.BucketedDistAttnRuntimeMgr),
                 "canonical_total": mgr.dispatch_meta.total_seqlen,
                 "local_rows": int(out_l.shape[0]), "mgr_id": id(mgr),
                 "out": out.detach().numpy(), "lse": lse.detach().numpy(),
                 **{f"d{n}": x[n].grad.numpy() for n in "qkv"}}
            if r["bucketed"]:
                r.update(dispatch_idx=mgr._bucket_dispatch_idx,
                         undispatch_idx=mgr._bucket_undispatch_idx,
                         position_ids=mgr._bucket_position_ids,
                         local_position_ids=api.get_position_ids(key).numpy(),
                         canonical_is_exact_key=api.get_runtime_mgr(mgr.canonical_key).plan
                         is mgr.plan)
            res[name] = r

        # the one-call and low-level entry points on request 0's mask: its key
        name, cu = requests[0]
        q = torch.from_numpy(inputs[name]["q"])
        kw = dict(num_heads=(q.shape[1], inputs[name]["k"].shape[1]), head_dim=q.shape[2],
                  chunk_size=case["chunk"], out_dtype=torch.float32, device="cpu")
        docs = list(zip(cu[:-1], cu[1:]))
        local_v, key_v = api.magi_attn_varlen_dispatch(q, cu, cu[-1], group, **kw)
        local_f, key_f = api.magi_attn_flex_dispatch(q, docs, docs, "causal", cu[-1], cu[-1],
                                                     group, **kw)
        mgr_i = api.init_dist_attn_runtime_mgr(
            docs, docs, ["causal"] * len(docs), cu[-1], cu[-1], kw["num_heads"][0],
            kw["num_heads"][1], kw["head_dim"], case["chunk"], group, pad_size=0, cp_mesh=None,
            out_dtype=torch.float32, device="cpu")
        want = api.dispatch(q, keys[name])
        entry_points = {
            "keys": key_v == key_f == keys[name],
            "locals": bool(torch.equal(local_v, want) and torch.equal(local_f, want)),
            "init_mgr": mgr_i is api.get_runtime_mgr(keys[name]),
        }

        def refusal(fn, *args):
            try:
                fn(*args)
            except ValueError as e:
                return str(e)
            return None

        bucketed = next(k for n, k in keys.items() if res[n]["bucketed"])
        n_tok = bucketed.total_seqlen_q - bucketed.pad_size
        local = api.dispatch(torch.zeros(n_tok, 1), bucketed)
        refusals = {
            "roll": refusal(api.roll, local, bucketed, 1),
            "new_flex": refusal(api.make_flex_key_for_new_mask_after_dispatch,
                                [(0, n_tok)], [(0, n_tok)], ["full"], bucketed),
            "new_varlen": refusal(api.make_varlen_key_for_new_mask_after_dispatch,
                                  [0, n_tok // 2, n_tok], bucketed),
        }
        os.environ["MAGI_ATTENTION_QO_COMM"] = "1"  # qo-comm plans the exact mask
        try:
            name, cu = requests[1]
            key, tier, _, _ = key_tier(interface, lambda: api.magi_attn_varlen_key(
                cu, cu[-1], group, num_heads=(x["q"].shape[1], x["k"].shape[1]),
                head_dim=x["q"].shape[2], chunk_size=case["chunk"], out_dtype=torch.float32,
                device="cpu"))
            qo_opt_out = {"tier": tier, "bucketed": isinstance(api.get_runtime_mgr(key),
                                                               api.BucketedDistAttnRuntimeMgr)}
        finally:
            os.environ.pop("MAGI_ATTENTION_QO_COMM")
        # a second group over the same ranks, with one bucketed key of its own
        other = dist.new_group(list(range(dist.get_world_size(group))))
        name, cu = requests[0]
        api.magi_attn_varlen_key(cu, cu[-1], other, num_heads=(x["q"].shape[1], x["k"].shape[1]),
                                 head_dim=x["q"].shape[2], chunk_size=case["chunk"],
                                 out_dtype=torch.float32, device="cpu")
        sizes = [(len(interface._runtime_dict), len(interface._plan_reuse_cache))]
        api.clear_cache(other)
        sizes.append((len(interface._runtime_dict), len(interface._plan_reuse_cache)))
        api.clear_cache(group)
        sizes.append((len(interface._runtime_dict), len(interface._plan_reuse_cache)))
        try:
            api.get_most_recent_key()
            recent_kept = True
        except RuntimeError:
            recent_kept = False
        return {"requests": res, "refusals": refusals, "cache_sizes": sizes,
                "most_recent_after_clear": recent_kept, "qo_opt_out": qo_opt_out,
                "entry_points": entry_points}
    finally:
        os.environ.pop("MAGI_ATTENTION_PLAN_REUSE", None)
        api.clear_cache()


def cp_decode(group, shards: list, q: np.ndarray, num_splits: int, page_size: int,
              max_pages: int, drop_rank: int | None = None) -> dict:
    """``serving.cp_decode_attn`` on the CPU: ``shards[rank][seq]`` is the
    (k, v) numpy pair of the tokens this rank holds of sequence ``seq``
    (maybe none), written into a local cache, one slot a sequence.
    ``drop_rank`` plants a merge that drops that rank's partial."""
    from magiattention_tpu_torch.serving import (
        assign_block_table, cp_decode, cp_decode_attn, make_paged_kv_cache, write_prefill_kv)

    rank, cp = dist.get_rank(group), dist.get_world_size(group)
    mine = shards[rank]
    d = q.shape[2]
    cache = make_paged_kv_cache(len(mine) * max_pages + 1, page_size, mine[0][0].shape[1], d,
                                max_seqs=len(mine), max_pages_per_seq=max_pages,
                                dtype=torch.float32, device="cpu")
    for slot, (k, v) in enumerate(mine):
        assign_block_table(cache, slot, list(range(1 + slot * max_pages,
                                                   1 + (slot + 1) * max_pages)))
        if k.shape[0]:
            write_prefill_kv(cache, slot, torch.from_numpy(k), torch.from_numpy(v))
    real = cp_decode.all_gather_v
    if drop_rank is not None:
        def dropping(x, sizes, grp):
            flat = real(x, sizes, grp)
            b = sizes[drop_rank]
            flat[drop_rank * b:(drop_rank + 1) * b] = 0.0 if x.dim() == 3 else float("-inf")
            return flat

        cp_decode.all_gather_v = dropping
    try:
        out, lse = cp_decode_attn(torch.from_numpy(q), cache, torch.arange(len(mine)),
                                  group=group, cp_size=cp, num_splits=num_splits)
    finally:
        cp_decode.all_gather_v = real
    return {"out": out.numpy(), "lse": lse.numpy()}


def cp_merge(group, outs: np.ndarray, lses: np.ndarray) -> dict:
    """``serving.cp_merge_partials`` of this rank's slice of ``outs`` / ``lses``."""
    from magiattention_tpu_torch.serving import cp_merge_partials

    rank, cp = dist.get_rank(group), dist.get_world_size(group)
    out, lse = cp_merge_partials(torch.from_numpy(outs[rank]), torch.from_numpy(lses[rank]),
                                 group=group, cp_size=cp)
    return {"out": out.numpy(), "lse": lse.numpy()}


# -- resilience on the cp path --------------------------------------------------------------


def resilience_cp(group, case: dict, runs: list, inputs: dict) -> list:
    """The keyed API (``dispatch`` -> ``calc_attn`` -> ``undispatch``, f32 on
    the CPU) once per run of ``runs``, each under its own flags
    (``run["env"]``, chaos rearmed first). A run whose ``calc_attn`` raises
    ``NumericalGuardError`` on some rank returns every rank's sites
    (``"raised"``: None where it did not raise) and skips the rest; else the
    global out and lse and, with ``run["grad"]``, dq / dk / dv of sum(out *
    g_out) + sum(lse * g_lse) over the finite lse, leaving out the rows
    ``run["skip_rows"]`` names (global q rows). ``case`` as
    :func:`keyed_attention`'s (impl, mask, degree, ...)."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.resilience import NumericalGuardError, reset_chaos

    results = []
    for run in runs:
        os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = run.get("impl", case["impl"])
        os.environ.update(run.get("env", {}))
        reset_chaos()
        try:
            q, k, v = (torch.from_numpy(inputs[n]).requires_grad_() for n in ("q", "k", "v"))
            key = api.magi_attn_flex_key(
                case["q_ranges"], case["k_ranges"], case["types"], case["total"], case["total"],
                group, num_heads=(q.shape[1], k.shape[1]), head_dim=q.shape[2],
                chunk_size=case["chunk"], out_dtype=torch.float32, device="cpu",
                dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(
                    degree=case["degree"], min_stage_rows=case["min_stage_rows"])))
            raised = None
            try:
                out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key),
                                            api.dispatch(v, key), key)
            except NumericalGuardError as e:
                raised = list(e.sites)
            every = [None] * dist.get_world_size(group)
            dist.all_gather_object(every, raised, group=group)
            if any(s is not None for s in every):
                results.append({"raised": every})
                continue
            out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
            res = {"out": out.detach().numpy(), "lse": lse.detach().numpy(),
                   "impls": [c.impl for c in api.get_runtime_mgr(key).plan.comms()],
                   "first_row_of_rank0": int(api.get_runtime_mgr(key).dispatch_meta
                                             .position_ids(0)[0])}
            if run.get("grad"):
                keep = torch.ones((out.shape[0], 1, 1))
                keep[list(run.get("skip_rows", ()))] = 0.0
                g_out = torch.from_numpy(inputs["g_out"]) * keep
                g_lse = torch.from_numpy(inputs["g_lse"]) * keep[:, :, 0]
                loss = (out * g_out).sum() + torch.where(torch.isfinite(lse), lse * g_lse,
                                                         0.0).sum()
                loss.backward()
                res.update(dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
            results.append(res)
        finally:
            for name in run.get("env", {}):
                os.environ.pop(name)
            reset_chaos()
    return results


def telemetry_aggregate(group, seed: int) -> dict:
    """Each rank records its own telemetry (values that differ by rank) and
    gathers the cross-rank aggregate over ``group``; returns the rank's
    snapshot and the aggregate it got."""
    from magiattention_tpu_torch import telemetry

    rank = dist.get_rank(group)
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        rng = np.random.default_rng(seed + rank)
        telemetry.record_decode_step(batch_size=rank + 1, num_splits=1,
                                     max_seq_len=int(rng.integers(1, 100)))
        telemetry.record_tier_state("decode", pages_in_use=10 * rank, active=rank + 1,
                                    replica=rank)
        for _ in range(rank + 2):
            telemetry.record_request_ttft(float(rng.exponential(0.01)))
        snap = telemetry.snapshot()
        return {"snapshot": snap, "aggregate": telemetry.aggregate_across_mesh(group=group)}
    finally:
        telemetry.set_enabled(None)
        telemetry.reset()


def census_cp(group, case: dict, inputs: dict) -> dict:
    """The keyed forward (``case``: mask, total, chunk, degree) under
    ``MAGI_ATTENTION_NUMERICS`` off, then census, then census with
    ``case["chaos"]`` planted: the global out and lse of each run, and the
    ``parallel`` layer's census values after the census runs (the host
    census, and the ``magi_numerics_census`` gauges)."""
    from magiattention_tpu_torch import api, telemetry
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.resilience import reset_chaos

    telemetry.set_enabled(True)
    res = {}
    try:
        for run, flags in (("off", {}), ("census", {"MAGI_ATTENTION_NUMERICS": "census"}),
                           ("planted", {"MAGI_ATTENTION_NUMERICS": "census",
                                        "MAGI_ATTENTION_CHAOS": case["chaos"]})):
            telemetry.reset()
            telemetry.reset_numerics_census()
            os.environ.update(flags)
            reset_chaos()
            try:
                q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
                key = api.magi_attn_flex_key(
                    case["q_ranges"], case["k_ranges"], case["types"], case["total"],
                    case["total"], group, num_heads=(q.shape[1], k.shape[1]),
                    head_dim=q.shape[2], chunk_size=case["chunk"], out_dtype=torch.float32,
                    device="cpu", dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(
                        degree=case["degree"], min_stage_rows=case["min_stage_rows"])))
                out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key),
                                            api.dispatch(v, key), key)
                gauges = {s: val for s, val in telemetry.snapshot()["gauges"].items()
                          if s.startswith("magi_numerics_census")}
                res[run] = {
                    "out": api.undispatch(out_l, key).numpy(),
                    "lse": api.undispatch(meta.lse, key).numpy(),
                    "census": telemetry.get_numerics_census().numerics_snapshot()["census"],
                    "gauges": gauges,
                    "num_stages": len(api.get_runtime_mgr(key).plan.stages),
                }
            finally:
                for name in flags:
                    os.environ.pop(name)
                reset_chaos()
                api.clear_cache()
        return res
    finally:
        telemetry.set_enabled(None)
        telemetry.reset()
        telemetry.reset_numerics_census()


def timeline_cp(group, case: dict, clock: list, factors: tuple) -> dict:
    """The keyed plan of ``case`` profiled twice: with a fake clock (each
    timed piece takes the next value of ``clock``) and the cost
    ``factors`` (calc, comm) given, and with the real clock and two reps;
    returns both timelines as dicts, the plan's stage count and the
    ``magi_overlap_*`` gauges of the real run."""
    from magiattention_tpu_torch import api, telemetry
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel.dist_attn import make_attn_params
    from magiattention_tpu_torch.telemetry.timeline import profile_plan_timeline

    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = case["impl"]
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        key = api.magi_attn_flex_key(
            case["q_ranges"], case["k_ranges"], case["types"], case["total"], case["total"],
            group, num_heads=case["heads"], head_dim=case["head_dim"], chunk_size=case["chunk"],
            out_dtype=torch.float32, device="cpu",
            dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(
                degree=case["degree"], min_stage_rows=case["min_stage_rows"])))
        plan = api.get_runtime_mgr(key).plan
        ticks = iter(clock)
        fake = profile_plan_timeline(
            plan, make_attn_params(plan, case["head_dim"], out_dtype=torch.float32), group,
            num_heads=case["heads"], head_dim=case["head_dim"], device="cpu",
            calc_cost_factor=factors[0], comm_cost_factor=factors[1],
            timer=lambda fn: next(ticks), record=False)
        real = api.profile_attn_timeline(key, reps=2, inner=1)
        try:  # operands made with no device named: the card, or a refusal
            profile_plan_timeline(plan, make_attn_params(plan, case["head_dim"]), group,
                                  num_heads=case["heads"], head_dim=case["head_dim"],
                                  timer=lambda fn: 1.0, record=False)
            no_device = "ran"
        except RuntimeError as e:
            no_device = str(e)
        gauges = {s: v for s, v in telemetry.snapshot()["gauges"].items()
                  if s.startswith("magi_overlap_")}
        return {"fake": dataclasses.asdict(fake), "real": dataclasses.asdict(real),
                "real_report": real.report(), "num_stages": len(plan.stages),
                "no_device": no_device,
                "degree": plan.overlap_degree, "gauges": gauges}
    finally:
        os.environ.pop("MAGI_ATTENTION_GROUP_COLL_IMPL", None)
        telemetry.set_enabled(None)
        telemetry.reset()
        api.clear_cache()


def plan_cache_stream(group, cus: list, chunk: int, runtime_size: int, flags: dict) -> dict:
    """Varlen-causal key resolutions of the ``cus`` (cu_seqlens lists) in
    order, with the runtime cache bounded at ``runtime_size`` and ``flags``
    set: the counters, and the names of every series present."""
    from magiattention_tpu_torch import api, telemetry
    from magiattention_tpu_torch.api import interface

    os.environ.update(flags)
    telemetry.set_enabled(True)
    telemetry.reset()
    api.clear_cache()
    saved = interface._runtime_dict.maxsize
    interface._runtime_dict.maxsize = runtime_size
    try:
        for cu in cus:
            api.magi_attn_varlen_key(cu, cu[-1], group, num_heads=(4, 2), head_dim=32,
                                     chunk_size=chunk, out_dtype=torch.float32, device="cpu")
        snap = telemetry.snapshot()
        names = {s.split("{")[0] for kind in ("counters", "gauges", "histograms")
                 for s in snap[kind]}
        return {"counters": snap["counters"], "names": sorted(names)}
    finally:
        interface._runtime_dict.maxsize = saved
        for name in flags:
            os.environ.pop(name)
        telemetry.set_enabled(None)
        telemetry.reset()
        api.clear_cache()


def tuned_key_blocking(group, cache_dirs: list, total: int, heads: tuple, head_dim: int,
                       chunk: int) -> dict:
    """A causal flex key on every rank, each rank with a tuning cache
    directory of its own, rank 1's holding a planted record (head_block 1)
    under the fingerprint of the key's decision: every rank must take rank
    0's decision. Returns the key's blocking and this rank's own
    (unbroadcast) decision."""
    from magiattention_tpu_torch import api, tuning

    rank = dist.get_rank(group)
    hq, hk = heads
    os.environ["MAGI_ATTENTION_AUTOTUNE_CACHE_DIR"] = cache_dirs[rank]
    tuning.reset_tuning_cache()
    try:
        cp = dist.get_world_size(group)
        mask = ([(0, total)], [(0, total)], [1])
        if rank == 1:
            fp = tuning.make_fingerprint(*mask, hq, hk, head_dim=head_dim, dtype=torch.float32,
                                         max_block_q=total // cp, max_block_k=total // cp,
                                         include_sparse=False, device="cpu")
            tuning.get_tuning_cache().put(fp, tuning.TuningRecord(
                block_q=64, block_k=64, head_block=1, source="measured", predicted_ms=1.0,
                measured_ms=1.0, candidates=()))
        own = tuning.resolve_block_config(*mask, total, total, cp, hq, hk, head_dim,
                                          str(torch.float32), device="cpu")
        key = api.magi_attn_flex_key(*mask, total, total, group, num_heads=heads,
                                     head_dim=head_dim, chunk_size=chunk,
                                     out_dtype=torch.float32, device="cpu")
        again = api.magi_attn_flex_key(*mask, total, total, group, num_heads=heads,
                                       head_dim=head_dim, chunk_size=chunk,
                                       out_dtype=torch.float32, device="cpu")
        return {"rank": rank, "key_blocking": key.block_config, "own": own,
                "same_key": again == key}
    finally:
        os.environ.pop("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR")
        tuning.reset_tuning_cache()
        api.clear_cache()


def _count_decisions(autotuner) -> list:
    """Wrap ``autotuner.select_block_config`` in this rank to count its
    calls; returns the list the calls append to (the wrapper stays for the
    rank's life: the caller restores ``autotuner.select_block_config``)."""
    calls = []
    inner = autotuner.select_block_config

    def counted(*a, **kw):
        calls.append(len(a[0]))
        return inner(*a, **kw)

    autotuner.select_block_config = counted
    return calls


def overlapping_group_blocking(group, rounds: int, cap: int) -> dict:
    """Keyed blockings on two groups that share ranks 0 and 1 (the world
    and {0, 1}), a new mask each round and memo tables of ``cap`` entries,
    so that the tables evict during the stream: each group's ranks must
    hit and miss together (a rank that misses alone enters a broadcast its
    peers skip, and the pool times out). Then the last ``cap`` masks
    again: every call a memo hit, no decision taken."""
    from magiattention_tpu_torch import tuning
    from magiattention_tpu_torch.tuning import autotuner

    rank = dist.get_rank(group)
    pair = dist.new_group([0, 1])
    inner, cap_was = autotuner.select_block_config, autotuner._AGREED.cap
    calls = _count_decisions(autotuner)
    autotuner._AGREED.cap = cap
    tuning.reset_tuning_cache()
    try:
        def stream(first: int):
            got = []
            for i in range(first, rounds):
                total = 1024 + 192 * i
                mask = ([(0, total)], [(0, total)], [1])
                got.append(tuning.resolve_block_config(
                    *mask, total, total, 3, 6, 3, 64, "torch.float32", group=group,
                    device="cpu"))
                if rank < 2:
                    got.append(tuning.resolve_block_config(
                        *mask, total, total, 2, 6, 3, 64, "torch.float32", group=pair,
                        device="cpu"))
            return got

        first = stream(0)
        decided = len(calls)
        again = stream(rounds - cap)
        return {"rank": rank, "first": first, "again": again, "decided": decided,
                "decided_again": len(calls) - decided}
    finally:
        autotuner.select_block_config, autotuner._AGREED.cap = inner, cap_was
        tuning.reset_tuning_cache()
        dist.destroy_process_group(pair)


def bucketed_key_blocking(group, stream: list, heads: tuple, head_dim: int, chunk: int) -> dict:
    """``magi_attn_varlen_key`` on each request of ``stream`` (lists of
    document lengths) under ``MAGI_ATTENTION_PLAN_REUSE=bucket``: each
    key's blocking and the decisions this rank took for it (rank 0 decides
    for the group; a bucket hit, an exact hit and the nested canonical key
    take none)."""
    from magiattention_tpu_torch import api, tuning
    from magiattention_tpu_torch.tuning import autotuner

    os.environ["MAGI_ATTENTION_PLAN_REUSE"] = "bucket"
    inner = autotuner.select_block_config
    calls = _count_decisions(autotuner)
    tuning.reset_tuning_cache()
    try:
        blockings, decisions = [], []
        for docs in stream:
            cu = np.concatenate([[0], np.cumsum(docs)]).tolist()
            n = len(calls)
            key = api.magi_attn_varlen_key(cu, cu[-1], group, num_heads=heads,
                                           head_dim=head_dim, chunk_size=chunk, device="cpu")
            blockings.append(key.block_config)
            decisions.append(len(calls) - n)
        return {"rank": dist.get_rank(group), "blockings": blockings, "decisions": decisions}
    finally:
        os.environ.pop("MAGI_ATTENTION_PLAN_REUSE")
        autotuner.select_block_config = inner
        tuning.reset_tuning_cache()
        api.clear_cache()
