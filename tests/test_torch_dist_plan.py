"""The port's host planning of context parallelism against the JAX
package's, byte for byte (host only, no processes): the dispatch
partitions, every per-rank stage table (``StageTables.arrays()``), every
cast's ``GroupCollectiveMeta`` routing arrays with its resolved impl, and
the overlap degree, over mask families x cp {2, 4} x overlap degree {0, 1,
2, auto} x group-collective impl {a2a, hops, auto}, both plans built at the
port kernels' 64 x 64 tile; then every partition-returning dispatch
algorithm over the masks at cp {2, 4} x degree {0, 2}, the uneven shard
(17 chunks), and the two bound-only algorithms raising in both packages. Then the range and rectangle algebra the
planners call, on the random inputs of ``tests/test_common/``: every
operation's result equal to the JAX package's."""

import random

import numpy as np
import pytest

from magiattention_tpu.common import AttnMaskType as JaxMaskType
from magiattention_tpu.common.enum import DispatchAlgType as JaxAlgType
from magiattention_tpu.common.range import AttnRange as JaxRange
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.common.rectangle import AttnRectangle as JaxRect
from magiattention_tpu.common.rectangle import AttnRectangles as JaxRects
from magiattention_tpu.meta.dispatch_meta import (
    make_dispatch_meta_from_qk_ranges as jax_dispatch_meta,
)
from magiattention_tpu.meta.solver.dispatch_solver import DispatchAlg as JaxDispatchAlg
from magiattention_tpu.meta.solver.dispatch_solver import DispatchConfig as JaxDispatchConfig
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.parallel.dist_attn import build_dist_attn_plan as jax_build_plan
from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
from magiattention_tpu_torch.common import AttnMaskType, AttnRange, AttnRanges, DispatchAlgType
from magiattention_tpu_torch.comm import HierGroupCollectiveMeta
from magiattention_tpu_torch.common.rectangle import AttnRectangle, AttnRectangles
from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu_torch.meta.solver.dispatch_solver import DispatchAlg, DispatchConfig
from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
from magiattention_tpu_torch.parallel import build_dist_attn_plan

TOTAL, CHUNK, BLOCK = 2048, 128, 64
MIN_STAGE_ROWS = 64  # small enough that degree 2 splits this size's remote rows
SEED = 0


def _window_with_global():
    qr, kr, ty = infer_attn_mask_from_cu_seqlens(
        [0, 768, 1536, TOTAL], causal=False, window_size=(200, 150), global_window_size=64)
    return [r.to_naive_range() for r in qr], [r.to_naive_range() for r in kr], list(ty)


MASKS = {
    "full": ([(0, TOTAL)], [(0, TOTAL)], [0]),
    "causal": ([(0, TOTAL)], [(0, TOTAL)], [1]),
    "varlen_block_causal": (
        [(0, 300), (300, 1100), (1100, 1500), (1500, TOTAL)],
        [(0, 300), (300, 1100), (1100, 1500), (1500, TOTAL)],
        [1, 1, 1, 1],
    ),
    "sliding_window_global": _window_with_global(),
    "shared_question": (  # one question attended by every answer (full), answers causal
        [(0, 512), (512, 1024), (1024, 1536), (1536, TOTAL), (512, 1024), (1024, 1536),
         (1536, TOTAL)],
        [(0, 512), (512, 1024), (1024, 1536), (1536, TOTAL), (0, 512), (0, 512), (0, 512)],
        [1, 1, 1, 1, 0, 0, 0],
    ),
}


def _plans(mask, cp, degree, alg=None, uneven=False, masks=None, total=TOTAL):
    """Both packages' dispatch metas and plans; ``alg`` (a ``DispatchAlgType``
    name) and ``uneven`` set the ``DispatchConfig`` (default: MinHeap, even)."""
    qr, kr, ty = (masks or MASKS)[mask]
    oc = dict(degree=degree, min_stage_rows=MIN_STAGE_ROWS)
    jcfg = pcfg = None
    if alg is not None or uneven:
        alg = alg or "MIN_HEAP"
        jcfg = JaxDispatchConfig(uneven_shard=uneven, alg=JaxDispatchAlg(JaxAlgType[alg]))
        pcfg = DispatchConfig(uneven_shard=uneven, alg=DispatchAlg(DispatchAlgType[alg]))
    random.seed(SEED)  # RANDOM_SELECT draws from the process's random module, in both
    jm, _, jb = jax_dispatch_meta(JaxRanges.from_ranges(qr), JaxRanges.from_ranges(kr),
                                  [JaxMaskType(t) for t in ty], total, total, CHUNK, cp,
                                  dispatch_config=jcfg)
    random.seed(SEED)
    pm, _, pb = make_dispatch_meta_from_qk_ranges(AttnRanges.from_ranges(qr),
                                                  AttnRanges.from_ranges(kr),
                                                  [AttnMaskType(t) for t in ty], total, total,
                                                  CHUNK, cp, dispatch_config=pcfg)
    jp = jax_build_plan(jm, jb, block_q=BLOCK, block_k=BLOCK,
                        overlap_config=JaxOverlapConfig(**oc))
    pp = build_dist_attn_plan(pm, pb, block_q=BLOCK, block_k=BLOCK,
                              overlap_config=OverlapConfig(**oc))
    return jm, pm, jp, pp


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def same_hier_meta(jm, pm, what):
    """Every field of a JAX hierarchical meta, byte for byte, and its
    volume accounting."""
    for f in ("n_inter", "n_intra", "recv_total", "inter_rows_total", "send_total", "pad_to",
              "impl", "impl_reason", "intra_true_rows", "intra_local_rows", "max_recv",
              "padded_rows_per_rank", "scheduled_rows_per_rank", "true_rows_total",
              "scheduled_rows_total", "padding_overhead_ratio"):
        assert getattr(pm, f) == getattr(jm, f), (what, f)
    for f in ("inter_send_idx", "inter_recv_sel", "inter_recv_valid", "intra_send_idx",
              "intra_recv_sel", "intra_recv_valid"):
        _same(getattr(jm, f), getattr(pm, f), f"{what}.{f}")
    assert len(pm.intra_hops) == len(jm.intra_hops), what
    for i, (jh, ph) in enumerate(zip(jm.intra_hops, pm.intra_hops)):
        assert (ph.shift, ph.size) == (jh.shift, jh.size), (what, i)
        for f in ("send_idx", "recv_pos", "seg_ids"):
            _same(getattr(jh, f), getattr(ph, f), f"{what}.hop{i}.{f}")


def _same_comm(jc, pc, what):
    if isinstance(pc, HierGroupCollectiveMeta):
        same_hier_meta(jc, pc, what)
        return
    assert pc.impl == jc.impl and pc.impl_reason == jc.impl_reason, (what, pc.impl, jc.impl)
    for f in ("cp_size", "max_send", "max_recv", "send_total", "recv_total", "pad_to",
              "local_rows_total"):
        assert getattr(pc, f) == getattr(jc, f), (what, f)
    for f in ("send_idx", "recv_sel", "recv_valid", "seg_ids"):
        _same(getattr(jc, f), getattr(pc, f), f"{what}.{f}")
    assert len(pc.hops) == len(jc.hops), what
    for i, (jh, ph) in enumerate(zip(jc.hops, pc.hops)):
        assert (ph.shift, ph.size) == (jh.shift, jh.size), (what, i)
        for f in ("send_idx", "recv_pos", "seg_ids"):
            _same(getattr(jh, f), getattr(ph, f), f"{what}.hop{i}.{f}")
    for j, p in zip(jc.cast_device_arrays(), pc.cast_device_arrays()):
        _same(j, p, f"{what}.cast_device_arrays")


def _same_tables(jt, pt, what):
    assert pt.kv_pad == jt.kv_pad, what
    assert (pt.num_q_blocks, pt.num_k_blocks) == (jt.num_q_blocks, jt.num_k_blocks), what
    for i, (j, p) in enumerate(zip(jt.arrays(), pt.arrays())):
        _same(j, p, f"{what}.arrays()[{i}]")


@pytest.mark.parametrize("impl", ["a2a", "hops", "auto"])
@pytest.mark.parametrize("degree", [0, 1, 2, None], ids=["d0", "d1", "d2", "dauto"])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plan_is_byte_identical_to_jax(mask, cp, degree, impl, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
    _same_plans(*_plans(mask, cp, degree), degree)
    if impl != "auto":
        assert all(c.impl == impl for c in _plans(mask, cp, degree)[3].comms())


def _same_plans(jm, pm, jp, pp, degree):
    """Two plans byte for byte (and, when given, their dispatch metas'
    partitions); flat or hierarchical comm."""
    if jm is not None:
        assert pm.partitions == jm.partitions
    for f in ("cp_size", "shard_q_len", "shard_q_pad", "block_q", "block_k", "overlap_degree",
              "total_area", "max_rank_area", "host_max_rank_area", "hier"):
        assert getattr(pp, f) == getattr(jp, f), f
    if degree == 0:
        assert pp.overlap_degree == 0
        _same_tables(jp.merged_tables, pp.merged_tables, "merged")
        _same_comm(jp.merged_comm, pp.merged_comm, "merged_comm")
    else:
        _same_tables(jp.host_tables, pp.host_tables, "host")
        assert len(pp.stages) == len(jp.stages)
        for i, (js, ps) in enumerate(zip(jp.stages, pp.stages)):
            assert ps.max_rank_area == js.max_rank_area
            _same_tables(js.tables, ps.tables, f"stage{i}")
            _same_comm(js.comm, ps.comm, f"stage{i}.comm")


# -- dispatch coverage: every dispatch algorithm, and the uneven shard --------------------------

PARTITIONING_ALGS = [a.name for a in DispatchAlgType
                     if a.name not in ("LOWER_BOUND", "DYNAMIC_PROGRAMMING")]
UNEVEN_TOTAL = 17 * CHUNK  # 17 chunks: no cp size here divides them
UNEVEN_DOCS = [(0, 300), (300, 1100), (1100, 1500), (1500, UNEVEN_TOTAL)]
UNEVEN_MASKS = {
    "full": ([(0, UNEVEN_TOTAL)], [(0, UNEVEN_TOTAL)], [0]),
    "causal": ([(0, UNEVEN_TOTAL)], [(0, UNEVEN_TOTAL)], [1]),
    "varlen_block_causal": (UNEVEN_DOCS, UNEVEN_DOCS, [1] * len(UNEVEN_DOCS)),
}


@pytest.mark.parametrize("degree", [0, 2], ids=["d0", "d2"])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("alg", PARTITIONING_ALGS)
def test_every_dispatch_algorithm_is_byte_identical_to_jax(alg, mask, cp, degree):
    _same_plans(*_plans(mask, cp, degree, alg=alg), degree)


@pytest.mark.parametrize("degree", [0, 2], ids=["d0", "d2"])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("mask", sorted(UNEVEN_MASKS))
def test_uneven_shard_is_byte_identical_to_jax(mask, cp, degree):
    jm, pm, jp, pp = _plans(mask, cp, degree, uneven=True, masks=UNEVEN_MASKS,
                            total=UNEVEN_TOTAL)
    assert pm.is_uneven and jm.is_uneven
    assert pm.rank_valid_lens == jm.rank_valid_lens
    _same_plans(jm, pm, jp, pp, degree)


@pytest.mark.parametrize("alg", ["LOWER_BOUND", "DYNAMIC_PROGRAMMING"])
def test_bound_only_algorithms_raise_in_both(alg):
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="does not return partitions"):
            if pkg == "jax":
                jax_dispatch_meta(JaxRanges.from_ranges([(0, TOTAL)]),
                                  JaxRanges.from_ranges([(0, TOTAL)]), [JaxMaskType(1)], TOTAL,
                                  TOTAL, CHUNK, 2, dispatch_config=JaxDispatchConfig(
                                      alg=JaxDispatchAlg(JaxAlgType[alg])))
            else:
                make_dispatch_meta_from_qk_ranges(
                    AttnRanges.from_ranges([(0, TOTAL)]), AttnRanges.from_ranges([(0, TOTAL)]),
                    [AttnMaskType(1)], TOTAL, TOTAL, CHUNK, 2,
                    dispatch_config=DispatchConfig(alg=DispatchAlg(DispatchAlgType[alg])))


def test_degree_two_stages_remote_rows():
    """The cases above do exercise multi-stage plans."""
    _, _, _, pp = _plans("causal", 4, 2)
    assert pp.overlap_degree == 2 and len(pp.stages) == 2


# -- the range and rectangle algebra, on tests/test_common/'s random inputs -----------------


def _rand_ranges(cls_range, cls_ranges, rng, n, hi, allow_overlap=True):
    rs = cls_ranges()
    for _ in range(n):
        a = int(rng.integers(0, hi - 1))
        b = int(rng.integers(a + 1, hi + 1))
        rs.append(cls_range(a, b))
    return rs if allow_overlap else rs.merge()


def _both_ranges(seed, n_max, hi, allow_overlap=True):
    """The same random ranges built in each package (the test_common draws)."""
    out = []
    for cls_range, cls_ranges in ((JaxRange, JaxRanges), (AttnRange, AttnRanges)):
        rng = np.random.default_rng(seed)
        out.append(_rand_ranges(cls_range, cls_ranges, rng, int(rng.integers(1, n_max)), hi,
                                allow_overlap))
    return out


def _naive(x):
    if isinstance(x, (list, tuple)):
        return [_naive(y) for y in x]
    if hasattr(x, "to_naive_ranges"):
        return x.to_naive_ranges()
    return x.to_naive_range() if hasattr(x, "to_naive_range") else x


@pytest.mark.parametrize("seed", range(20))
def test_range_algebra_matches_jax(seed):
    j, p = _both_ranges(seed, 10, 200)
    j2, p2 = _both_ranges(seed + 1000, 8, 200)
    for op in (lambda r, o: r.merge(), lambda r, o: r.sort(),
               lambda r, o: r.merge_with_split_alignment(16),
               lambda r, o: r.find_hole_ranges(o), lambda r, o: r.find_overlap_ranges(o),
               lambda r, o: r.truncate(20, 150), lambda r, o: r.intersect_size_with(o),
               lambda r, o: r.union_size_with(o), lambda r, o: r.points,
               lambda r, o: (r.is_sorted(), r.is_merged(), r.is_non_overlap(), r.total_seqlen,
                             r.max_seqlen, r.union_size(), r.intersect_size())):
        assert _naive(op(p, p2)) == _naive(op(j, j2))
    jn, pn = _both_ranges(seed, 8, 300, allow_overlap=False)
    chunk = 1 + seed * 7
    assert _naive(pn.chunk(chunk, check=False)) == _naive(jn.chunk(chunk, check=False))
    sub_j = jn.find_overlap_ranges(JaxRanges.from_ranges([(30, 120), (140, 260)]))
    sub_p = pn.find_overlap_ranges(AttnRanges.from_ranges([(30, 120), (140, 260)]))
    assert _naive(pn.make_ranges_local(sub_p)) == _naive(jn.make_ranges_local(sub_j))
    for a, b in zip(p, j):  # the single-range algebra
        for q, r in zip(p2, j2):
            assert _naive(a.intersect(q)) == _naive(b.intersect(r))
            assert _naive(a.union(q)) == _naive(b.union(r))
            assert _naive(a.diff_by(q)) == _naive(b.diff_by(r))
            assert (a.intersect_size(q), a.union_size(q), a.is_subrange_of(q),
                    a.is_overlap_with(q)) == (b.intersect_size(r), b.union_size(r),
                                              b.is_subrange_of(r), b.is_overlap_with(r))
        assert _naive(a.offset(3)) == _naive(b.offset(3))
        assert _naive(a.truncate(10, 90)) == _naive(b.truncate(10, 90))


SPAN = 48


def _rect_desc(r):
    return None if r is None else (r.q_range.to_naive_range(), r.k_range.to_naive_range(),
                                   int(r.mask_type), r.area)


@pytest.mark.parametrize("mt", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", range(6))
def test_rectangle_algebra_matches_jax(mt, seed):
    rng = np.random.default_rng(seed)
    qs = int(rng.integers(0, SPAN - 2))
    qe = int(rng.integers(qs + 1, SPAN))
    ks = int(rng.integers(0, SPAN - 2))
    ke = int(rng.integers(ks + 1, SPAN))
    j = JaxRect(JaxRange(qs, qe), JaxRange(ks, ke), JaxMaskType(mt))
    p = AttnRectangle(AttnRange(qs, qe), AttnRange(ks, ke), AttnMaskType(mt))
    assert p.area == j.area
    for pos in range(0, SPAN, 5):
        assert [_rect_desc(x) for x in p.cut_q(pos)] == [_rect_desc(x) for x in j.cut_q(pos)]
        pl, pr = p.cut_k_multi(pos)
        jl, jr = j.cut_k_multi(pos)
        assert [_rect_desc(x) for x in pl + pr] == [_rect_desc(x) for x in jl + jr]
    rj = JaxRects.from_ranges([(qs, qe), (0, SPAN)], [(ks, ke), (0, SPAN)], [mt, 1])
    rp = AttnRectangles.from_ranges([(qs, qe), (0, SPAN)], [(ks, ke), (0, SPAN)], [mt, 1])
    for pos in range(0, SPAN, 7):
        assert rp.area_left_of_k(pos) == rj.area_left_of_k(pos)
        assert rp.area_left_of_q(pos) == rj.area_left_of_q(pos)
        assert [len(x) for x in rp.cut_k(pos)] == [len(x) for x in rj.cut_k(pos)]
    np.testing.assert_array_equal(rp.to_array(), rj.to_array())


# -- hierarchical plans and cross-attention plans ----------------------------------------


def _hier_plans(mask, shape, degree, total=TOTAL):
    """Both packages' plans of ``mask`` over cp_mesh_shape ``shape``."""
    qr, kr, ty = MASKS[mask]
    cp = shape[0] * shape[1]
    oc = dict(degree=degree, min_stage_rows=MIN_STAGE_ROWS)
    jm, _, jb = jax_dispatch_meta(JaxRanges.from_ranges(qr), JaxRanges.from_ranges(kr),
                                  [JaxMaskType(t) for t in ty], total, total, CHUNK, cp)
    pm, _, pb = make_dispatch_meta_from_qk_ranges(AttnRanges.from_ranges(qr),
                                                  AttnRanges.from_ranges(kr),
                                                  [AttnMaskType(t) for t in ty], total, total,
                                                  CHUNK, cp)
    jp = jax_build_plan(jm, jb, block_q=BLOCK, block_k=BLOCK, cp_mesh_shape=shape,
                        overlap_config=JaxOverlapConfig(**oc))
    pp = build_dist_attn_plan(pm, pb, block_q=BLOCK, block_k=BLOCK, cp_mesh_shape=shape,
                              overlap_config=OverlapConfig(**oc))
    return jm, pm, jp, pp


@pytest.mark.parametrize("impl", ["a2a", "hops", "auto"])
@pytest.mark.parametrize("degree", [0, 2, None], ids=["d0", "d2", "dauto"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2)], ids=["2x2", "2x4", "4x2"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_hier_plan_is_byte_identical_to_jax(mask, shape, degree, impl, monkeypatch):
    """cp_mesh_shape plans: every merged and staged cast a
    ``HierGroupCollectiveMeta`` byte-identical to JAX's (2 x 4 and 4 x 2
    are host-only: eight ranks)."""
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
    jm, pm, jp, pp = _hier_plans(mask, shape, degree)
    assert pp.hier == jp.hier == shape
    assert all(isinstance(c, HierGroupCollectiveMeta) for c in pp.comms())
    assert pp.shard_k_len == pm.shard_seqlen
    _same_plans(jm, pm, jp, pp, degree)


def _cross_masks():
    """(q_ranges, k_ranges, types, tq, tk): queries over tq rows attending
    to a memory of tk rows, both chunk multiples over the ranks."""
    tq, tk = 1536, 2560
    return {
        "docs_full": ([(0, 512), (512, 1024), (1024, tq)], [(0, 1280), (1280, 1920), (1920, tk)],
                      [0, 0, 0], tq, tk),
        "shared_prefix_causal": ([(0, 768), (768, tq)], [(0, 1536), (512, tk)], [0, 1], tq, tk),
    }


@pytest.mark.parametrize("degree", [0, 1, 2], ids=["d0", "d1", "d2"])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("mask", sorted(_cross_masks()))
def test_cross_plan_is_byte_identical_to_jax(mask, cp, degree):
    """``make_cross_attn_dispatch_meta`` (both roles) and the plan over the
    K side's own ``kv_dispatch_meta``."""
    from magiattention_tpu.meta.dispatch_meta import make_cross_attn_dispatch_meta as jax_cross
    from magiattention_tpu_torch.meta import make_cross_attn_dispatch_meta

    qr, kr, ty, tq, tk = _cross_masks()[mask]
    chunk_q, chunk_k = 128, 64
    jq, jk, jb = jax_cross(JaxRanges.from_ranges(qr), JaxRanges.from_ranges(kr),
                           [JaxMaskType(t) for t in ty], tq, tk, chunk_q, chunk_k, cp)
    pq, pk, pb = make_cross_attn_dispatch_meta(AttnRanges.from_ranges(qr),
                                               AttnRanges.from_ranges(kr),
                                               [AttnMaskType(t) for t in ty], tq, tk, chunk_q,
                                               chunk_k, cp)
    for j, p in ((jq, pq), (jk, pk)):
        assert (p.total_seqlen, p.chunk_size, p.num_chunks, p.cp_size, p.partitions) == (
            j.total_seqlen, j.chunk_size, j.num_chunks, j.cp_size, j.partitions)
        _same(j.perm_idx, p.perm_idx, "perm_idx")
    oc = dict(degree=degree, min_stage_rows=MIN_STAGE_ROWS)
    jp = jax_build_plan(jq, jb, kv_dispatch_meta=jk, block_q=BLOCK, block_k=BLOCK,
                        overlap_config=JaxOverlapConfig(**oc))
    pp = build_dist_attn_plan(pq, pb, kv_dispatch_meta=pk, block_q=BLOCK, block_k=BLOCK,
                              overlap_config=OverlapConfig(**oc))
    assert (pp.shard_q_len, pp.shard_k_len) == (tq // cp, tk // cp)
    _same_plans(jq, pq, jp, pp, degree)


def test_cross_dispatch_meta_refuses_what_jax_refuses():
    from magiattention_tpu.meta.dispatch_meta import make_cross_attn_dispatch_meta as jax_cross
    from magiattention_tpu_torch.meta import make_cross_attn_dispatch_meta

    for tq, tk, cq, ck in ((1536, 2500, 128, 64), (1536, 64 * 6, 128, 64), (1000, 2560, 128, 64)):
        msgs = []
        for fn, ranges in ((jax_cross, JaxRanges), (make_cross_attn_dispatch_meta, AttnRanges)):
            with pytest.raises(ValueError) as e:
                fn(ranges.from_ranges([(0, tq)]), ranges.from_ranges([(0, tk)]), [0], tq, tk, cq,
                   ck, 4)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
