"""The device profilers of the port's ``telemetry/`` against the JAX
package's, on the CPU at small sizes:

- the counting (``tuning/cost_model.py``: entries, steps, q blocks, the
  slice digest), the occupancy maps (``telemetry/occupancy.py``, JSON
  artifacts read across packages) and the roofline's areas, grid slots and
  modeled seconds (``telemetry/roofline.py``, JAX's step fees passed to the
  port) equal JAX's exactly for causal, varlen and heterogeneous masks at
  the 64 x 64 tile; the map's enumeration is the port's own plan's live
  (q block, k block) pairs, the pairs the sparse grid walks;
- the timeline's prediction (``_predicted_costs``) equals JAX's on the
  same plan and factors (relative 1e-12);
- the decode census (``MAGI_ATTENTION_NUMERICS=census``) lands the values
  JAX's lands for the same cache state (rtol 1e-5, atol 1e-6: f32 sums in
  two orders), outputs bit for bit the census-off ones;
- the peak and timeline flags read as JAX's, with JAX's messages, and the
  card's peak table holds the H100's datasheet row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import env as jax_env
from magiattention_tpu import serving as jsv
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges as jax_meta
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.parallel.dist_attn import build_dist_attn_plan as jax_build_plan
from magiattention_tpu.telemetry import numerics as jnum
from magiattention_tpu.telemetry import occupancy as jocc
from magiattention_tpu.telemetry import roofline as jroof
from magiattention_tpu.telemetry import timeline as jtl
from magiattention_tpu.tuning import cost_model as jcm
from magiattention_tpu_torch import env, telemetry
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.convert import cache_from_numpy
from magiattention_tpu_torch.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.parallel.dist_attn import build_dist_attn_plan
from magiattention_tpu_torch.serving import decode_attn_paged
from magiattention_tpu_torch.telemetry import numerics, occupancy, roofline, timeline
from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal
from magiattention_tpu_torch.tuning import cost_model
from magiattention_tpu_torch.utils import cost
from tests.torch_jax_backend import jax_backend

B = 64  # the kernels' tile

MASKS = {
    "causal": ([(0, 512)], [(0, 512)], [1]),
    "varlen": ([(0, 100), (100, 230), (230, 512)], [(0, 100), (100, 230), (230, 512)],
               [1, 1, 1]),
    "hetero": split_slices(varlen_block_causal(1024, n_docs=6, seed=3)),
    "full_offset": ([(0, 200), (200, 448)], [(64, 300), (0, 448)], [0, 2]),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("MAGI_ATTENTION_PEAK_TFLOPS", "MAGI_ATTENTION_NUMERICS",
                 "MAGI_ATTENTION_TIMELINE_REPS", "MAGI_ATTENTION_TIMELINE_INNER",
                 "MAGI_ATTENTION_GRID"):
        monkeypatch.delenv(name, raising=False)
    yield
    telemetry.set_enabled(None)
    telemetry.reset()
    telemetry.reset_numerics_census()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_counting_and_occupancy_are_jaxs(name, tmp_path):
    qr, kr, ts = MASKS[name]
    assert cost_model.estimate_entries(qr, kr, ts, B, B) == jcm.estimate_entries(qr, kr, ts, B, B)
    pq, pk, pt = cost_model._normalize_slices(qr, kr, ts)
    assert cost_model.slices_digest(pq, pk, pt) == jcm.slices_digest(*jcm._normalize_slices(
        qr, kr, ts))
    for (q0, q1), (k0, k1), t in zip(qr, kr, ts):
        for a, b in zip(cost_model.slice_block_k_spans(q0, q1, k0, k1, t, B),
                        jcm.slice_block_k_spans(q0, q1, k0, k1, t, B)):
            np.testing.assert_array_equal(a, b)
    occ = occupancy.block_occupancy_map(qr, kr, ts, B, B)
    jmap = jocc.block_occupancy_map(qr, kr, ts, B, B)
    assert occ.as_json() == jmap.as_json()
    assert occ.ascii_heatmap() == jmap.ascii_heatmap()
    # the artifact reads across packages
    path = str(tmp_path / "occ.json")
    jmap.dump(path)
    assert occupancy.BlockOccupancyMap.load(path) == occ
    occ.dump(path)
    assert jocc.BlockOccupancyMap.load(path).as_json() == jmap.as_json()
    # the enumeration is the live (q block, k block) pairs the port's own
    # plan schedules: the sparse grid's walk
    enum = occ.to_enumeration()
    total_q, total_k = max(b for _, b in qr), max(b for _, b in kr)
    meta = fa.build_block_meta(qr, kr, ts, total_q, total_k, block_q=B, block_k=B)
    live = meta.fwd_slice_id < meta.num_slices
    planned = set(zip(meta.fwd_q_block[live].tolist(), meta.fwd_k_block[live].tolist()))
    assert set(zip(enum.major.tolist(), enum.minor.tolist())) == planned


@pytest.mark.parametrize("grid", ["row_major", "sparse"])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_roofline_accounting_is_jaxs(name, grid, monkeypatch):
    """Areas, grid slots, bytes, and the modeled seconds with JAX's step
    fees given to the port (the port's own default is the fees fitted on
    the card) at one peak, set for both through MAGI_ATTENTION_PEAK_TFLOPS."""
    qr, kr, ts = MASKS[name]
    monkeypatch.setenv("MAGI_ATTENTION_PEAK_TFLOPS", "123.5")
    kw = dict(num_heads_q=8, num_heads_kv=2, head_dim=64, block_q=B, block_k=B, head_block=4,
              grid=grid, measured_ms=0.25, workload=name)
    fees = roofline.StepFees(jcm.STEP_OVERHEAD_S, jcm.DEAD_STEP_OVERHEAD_S,
                             jcm.SPARSE_STEP_OVERHEAD_S)
    got = roofline.analyze_workload(qr, kr, ts, fees=fees, device="cpu", **kw)
    want = jroof.analyze_workload(qr, kr, ts, **kw)
    for f in ("peak_tflops", "mask_area", "covered_area", "tile_area", "mask_density", "entries",
              "steps", "num_q_blocks", "grid_rows", "live_slots", "dead_slots", "bytes_moved",
              "measured_tflops", "measured_ms", "mask_flops", "scheduled_flops",
              "ideal_seconds", "modeled_seconds", "efficiency", "dominant_waste"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12), f
    assert got.gap_fractions() == pytest.approx(want.gap_fractions(), rel=1e-12)
    assert got.mask_area <= got.covered_area <= got.tile_area
    # the port's default fees are the cost model's, fitted on the H100
    fitted = roofline.analyze_workload(qr, kr, ts, device="cpu", **kw)
    assert fitted.dead_step_seconds == fitted.dead_slots * cost_model.DEAD_SLOT_S
    live_fee = cost_model.SPARSE_SLOT_S if grid == "sparse" else cost_model.LIVE_SLOT_S
    assert fitted.live_step_seconds == pytest.approx(fitted.live_slots * live_fee, rel=1e-12)


def test_peak_table_and_flags(monkeypatch):
    h100 = cost.CARD_PEAK_SPECS["NVIDIA H100 80GB HBM3"]
    assert (h100.bf16_tflops, h100.hbm_gbps, h100.power_w) == (989.0, 3350.0, 700.0)
    assert roofline.resolve_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert roofline.resolve_peak_tflops(device="cpu") == jroof.CPU_PEAK_TFLOPS
    assert cost.get_calc_cost_factor(32, 128, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(4 * 32 * 128 / 989e12)
    assert cost.get_comm_cost_factor(8, 128, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(2 * 8 * 128 * 2 / 450e9)
    with pytest.raises(ValueError, match="unknown card"):
        roofline.resolve_peak_tflops("Some Card")
    monkeypatch.setenv("MAGI_ATTENTION_PEAK_TFLOPS", "500")
    assert roofline.resolve_peak_tflops("Some Card") == 500.0
    assert roofline.resolve_peak_tflops(device="cpu") == 500.0


@pytest.mark.parametrize("var,value,accessor", [
    ("MAGI_ATTENTION_PEAK_TFLOPS", "989", "peak_tflops_override"),
    ("MAGI_ATTENTION_PEAK_TFLOPS", "-3", "peak_tflops_override"),
    ("MAGI_ATTENTION_PEAK_TFLOPS", "fast", "peak_tflops_override"),
    ("MAGI_ATTENTION_PEAK_TFLOPS", " ", "peak_tflops_override"),
    ("MAGI_ATTENTION_TIMELINE_REPS", "7", "timeline_reps"),
    ("MAGI_ATTENTION_TIMELINE_REPS", "many", "timeline_reps"),
    ("MAGI_ATTENTION_TIMELINE_INNER", "3", "timeline_inner"),
    ("MAGI_ATTENTION_TIMELINE_INNER", "1.5", "timeline_inner"),
])
def test_profiler_flags_read_as_jax(var, value, accessor, monkeypatch):
    def outcome(fn):
        try:
            return ("ok", fn())
        except ValueError as e:
            return ("error", str(e))

    monkeypatch.setenv(var, value)
    assert outcome(getattr(env, accessor)) == outcome(getattr(jax_env, accessor))


def test_profile_roofline_measures_on_the_cpu_and_records():
    telemetry.set_enabled(True)
    telemetry.reset()
    qr, kr, ts = MASKS["varlen"]
    rep = telemetry.profile_roofline(qr, kr, ts, num_heads_q=4, num_heads_kv=2, head_dim=32,
                                     device="cpu", dtype=torch.float32, measure=True, reps=2,
                                     workload="varlen")
    assert rep.card == "cpu" and rep.measured_ms > 0 and 0 < rep.efficiency
    # the blocking the kernel would run: the density rule's sparse grid here
    assert (rep.block_q, rep.block_k, rep.head_block, rep.grid) == \
        fa.auto_kernel_config(qr, kr, 4, 2, attn_type_map=ts, head_dim=32) == (B, B, 2, "sparse")
    names = {s.split("{")[0] for s in telemetry.snapshot()["gauges"]}
    assert set(telemetry.REQUIRED_ROOFLINE_METRICS) <= names
    assert "masked-entry overcompute" in rep.report()


@pytest.mark.parametrize("degree", [0, 2])
def test_predicted_costs_are_jaxs(degree):
    """The timeline's prediction on byte-identical plans (cp 4, varlen
    causal), priced with the same factors."""
    qr, kr, ts = MASKS["varlen"]
    pm, _, pb = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr), ts, 512, 512, 32, 4)
    jm, _, jb = jax_meta(JaxRanges.from_ranges(qr), JaxRanges.from_ranges(kr), ts, 512, 512,
                         32, 4)
    plan = build_dist_attn_plan(pm, pb, block_q=B, block_k=B,
                                overlap_config=OverlapConfig(degree=degree, min_stage_rows=32))
    jplan = jax_build_plan(jm, jb, block_q=B, block_k=B,
                           overlap_config=JaxOverlapConfig(degree=degree, min_stage_rows=32))
    kw = dict(num_heads_q=4, num_heads_kv=2, head_dim=32, bytes_per_elt=4,
              calc_cost_factor=3e-12, comm_cost_factor=2e-9)
    got = timeline._predicted_costs(plan, card=None, **kw)
    want = jtl._predicted_costs(jplan, generation=None, **kw)
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    for g, w in zip(got[1:3], want[1:3]):
        assert g == pytest.approx(w, rel=1e-12)
    assert got[3] == pytest.approx(want[3], rel=1e-12)
    assert timeline._predicted_costs(plan, card=None, **{
        k: v for k, v in kw.items() if "factor" not in k}) is None  # no card: no prediction


HQ, HK, D, PS, MPP, NB = 4, 2, 16, 8, 4, 3


def _decode_state(seed=0):
    rng = np.random.default_rng(seed)
    num_pages = NB * MPP + 1
    k = rng.standard_normal((num_pages, PS, HK, D)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (num_pages, PS, HK, D)).astype(np.float32)
    tables = 1 + rng.permutation(num_pages - 1).reshape(NB, MPP).astype(np.int32)
    lens = np.array([5, 17, 32], np.int32)
    q = rng.standard_normal((NB, HQ, D)).astype(np.float32)
    jcache = jsv.make_paged_kv_cache(num_pages, PS, HK, D, max_seqs=NB, max_pages_per_seq=MPP,
                                     dtype=jnp.float32)
    jcache = type(jcache)(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(lens))
    return jcache, cache_from_numpy(k, v, tables, lens), q


def test_decode_census_is_jaxs(monkeypatch):
    jax_backend(monkeypatch)
    jcache, cache, q = _decode_state()
    slots = np.arange(NB)

    def port():
        return decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots),
                                 num_splits=2)

    off = port()
    monkeypatch.setenv("MAGI_ATTENTION_NUMERICS", "census")
    telemetry.set_enabled(True)
    telemetry.reset_numerics_census()
    jnum.reset_numerics_census()
    on = port()
    assert all(torch.equal(a, b) for a, b in zip(off, on))  # the census changes no bit
    jsv.decode_attn_paged(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=2)
    got = telemetry.get_numerics_census().numerics_snapshot()["census"]["decode"]
    want = jnum.get_numerics_census().numerics_snapshot()["census"]["decode"]
    assert set(got) == set(want) == {"split0", "split1", "final"}
    for site, stats in want.items():
        assert set(got[site]) == set(stats)
        for stat, val in stats.items():
            np.testing.assert_allclose(got[site][stat], val, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{site}/{stat}")
    assert got["final"]["mass_dev"] < 1e-5
    names = {s.split("{")[0] for kind in ("gauges", "histograms")
             for s in telemetry.snapshot()[kind]}
    assert {"magi_numerics_census", "magi_numerics_out_max_abs",
            "magi_numerics_mass_dev"} <= names


def test_census_reductions_are_jaxs():
    rng = np.random.default_rng(5)
    out = rng.standard_normal((6, 3, 8)).astype(np.float32)
    lses = [rng.standard_normal((6, 3)).astype(np.float32) for _ in range(3)]
    lses[1][2] = -np.inf  # an uncovered row of one partial
    merged = np.logaddexp.reduce(np.stack(lses), axis=0).astype(np.float32)
    merged[4] = -np.inf  # and an uncovered merged row
    for a, b in zip(numerics.site_summary(torch.from_numpy(out), torch.from_numpy(lses[1])),
                    jnum.site_summary(jnp.asarray(out), jnp.asarray(lses[1]))):
        assert float(a) == float(b)
    got = numerics.mass_deviation([torch.from_numpy(x) for x in lses], torch.from_numpy(merged))
    want = jnum.mass_deviation([jnp.asarray(x) for x in lses], jnp.asarray(merged))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    assert numerics.census_keys(("host", "stage0")) == jnum.census_keys(("host", "stage0"))


def test_overlap_solver_quality_is_jaxs():
    """The greedy stage split's balance gauges, as JAX records them."""
    from magiattention_tpu import telemetry as jtel
    from magiattention_tpu.meta.solver import overlap_solver as jos
    from magiattention_tpu_torch.meta.solver import overlap_solver as pos

    costs = [(3.0, 1.0), (1.0, 2.0), (4.0, 0.5), (2.0, 2.0), (0.5, 3.0)]
    telemetry.set_enabled(True)
    telemetry.reset()
    jtel.set_enabled(True)
    jtel.reset()
    try:
        for m, tel in ((pos, telemetry), (jos, jtel)):
            m.OverlapSolver(m.OverlapConfig(alg=m.OverlapAlgType.GREEDY)).solve(
                [m.OverlapStageCost(comm_cost=a, calc_cost=b) for a, b in costs], degree=3)
        got = {k: v for k, v in telemetry.snapshot()["gauges"].items()
               if k.startswith("magi_overlap_solver_")}
        want = {k: v for k, v in jtel.snapshot()["gauges"].items()
                if k.startswith("magi_overlap_solver_")}
        assert got == want and set(got) == {"magi_overlap_solver_chunks",
                                            "magi_overlap_solver_stage_balance_ratio"}
    finally:
        jtel.set_enabled(None)
        jtel.reset()


def test_the_roofline_runs_on_the_card_unless_asked_for_the_cpu():
    """``profile_roofline`` defaults to the card: with none it raises (no
    fallback to the CPU), and the peak needs a card or a named one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    qr, kr, ts = MASKS["causal"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry.profile_roofline(qr, kr, ts, num_heads_q=4, num_heads_kv=2, head_dim=32,
                                   record=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.resolve_peak_tflops()


def test_a_scoped_registry_keeps_its_records_apart():
    """Records made inside ``scoped_registry`` land in its registry alone,
    and the process registry is back, untouched, after the block."""
    telemetry.reset()
    outer = telemetry.get_registry()
    outer.counter_inc("magi_test_outer_total")
    with telemetry.scoped_registry() as reg:
        assert telemetry.get_registry() is reg is not outer
        telemetry.get_registry().counter_inc("magi_test_inner_total", 2)
        assert telemetry.snapshot()["counters"] == {"magi_test_inner_total": 2}
    assert telemetry.get_registry() is outer
    assert telemetry.snapshot()["counters"] == {"magi_test_outer_total": 1}


@pytest.mark.parametrize("impl", ["a2a", "hops"])
def test_comm_build_records_are_jaxs(impl):
    """A cast's build records (rows, overhead ratio, impl choice) as JAX's,
    and the routing a rank's reduce records its overhead from carries the
    meta's ratio."""
    from magiattention_tpu import telemetry as jtel
    from magiattention_tpu.comm.group_collective import GroupCollectiveMeta as JaxMeta
    from magiattention_tpu_torch.comm.group_collective import GroupCollectiveMeta, rank_routing

    rng = np.random.default_rng(2)
    smap = [[np.sort(rng.choice(40, int(rng.integers(0, 12)), replace=False)).astype(np.int64)
             if s != d else np.empty(0, np.int64) for d in range(4)] for s in range(4)]
    telemetry.set_enabled(True)
    telemetry.reset()
    jtel.set_enabled(True)
    jtel.reset()
    try:
        meta = GroupCollectiveMeta.build(smap, [40] * 4, impl=impl)
        JaxMeta.build(smap, [40] * 4, impl=impl)
        got = {k: v for k, v in telemetry.snapshot()["gauges"].items() if k.startswith("magi_comm")}
        want = {k: v for k, v in jtel.snapshot()["gauges"].items() if k.startswith("magi_comm")}
        assert got == want and got
        assert telemetry.snapshot()["counters"] == {"magi_group_collective_builds_total": 1.0}
        rt = rank_routing(meta, 1, 40, "cpu")
        telemetry.record_comm_op(rt, "reduce_lse")
        key = "magi_comm_padding_overhead_ratio{kind=reduce_lse}"
        assert telemetry.snapshot()["gauges"][key] == meta.padding_overhead_ratio
    finally:
        jtel.set_enabled(None)
        jtel.reset()
