"""Mask-aware roofline: where a flex kernel's time goes against the card's peak.

The port's copy of the JAX package's ``telemetry/roofline.py``. The TF/s
convention divides the TRUE mask FLOPs (4 * pairs * hq * d) by the time, but
the kernels schedule whole ``block_q x block_k`` tiles, so a sparse mask
pays for work the convention never credits. The gap is decomposed with the
cost model's own counting (``tuning/cost_model.py``) at three nested areas:

- ``A``: the exact mask area (valid pairs; the convention's FLOPs);
- ``C``: each q block's exact attended k interval, before tiling.
  ``C - A`` is masked-entry overcompute (the causal wedge inside a tile row);
- ``B``: every scheduled entry's whole tile (dummies included). ``B - C``
  is partial-tile waste (rows past a slice's end, columns past its interval);

and the grid: live slots pay a per-step fee, and a row-major grid's clamped
dead steps (rows shorter than the grid's ``steps`` extent) another. The
fees are a parameter (:class:`StepFees`), by default the ones the cost
model fitted on the H100; what they do not explain lands in
``unattributed``.

The achieved rate is divided by the card's peak (``utils/cost.py``;
``MAGI_ATTENTION_PEAK_TFLOPS`` overrides), and the gap is attributed term
by term as modeled seconds over measured seconds, with the honest
``unattributed`` residual. :func:`analyze_workload` is host-side numpy on
the slice lists; :func:`profile_roofline` can time the port's flex kernel
on the card (CUDA events, a spin kernel holding the stream while the host
enqueues, the median of reps). :func:`~.collectors.record_roofline` writes
the ``magi_roofline_*`` gauges.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np

from ..tuning.cost_model import (
    DEAD_SLOT_S,
    LIVE_SLOT_S,
    SPARSE_SLOT_S,
    _normalize_slices,
    estimate_entries,
    exact_mask_area,
    slice_block_k_spans,
)

# the peak on the CPU, where the plain versions run: obviously not a card's
# (efficiencies far above 100% or far below 1% both read as "wrong
# denominator"), and finite
CPU_PEAK_TFLOPS = 0.10


@dataclasses.dataclass(frozen=True)
class StepFees:
    """Fixed seconds per grid slot: a live row-major step, a clamped dead
    one, and the sparse grid's extra per live step (its live slot's fee
    less the row-major one's; negative where a sparse slot is the cheaper).
    The defaults are the cost model's fees (``tuning/cost_model.py``:
    ``LIVE_SLOT_S``, ``DEAD_SLOT_S``, ``SPARSE_SLOT_S``), fitted by least
    squares on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name,
    power.limit) by ``chip_smoke.py``'s ``tuning`` phase in its first chip
    run, before the model used them."""

    live_s: float = LIVE_SLOT_S
    dead_s: float = DEAD_SLOT_S
    sparse_extra_s: float = SPARSE_SLOT_S - LIVE_SLOT_S


def _resolve_card(card: str | None, device) -> str:
    """``card``, else ``"cpu"`` for a CPU ``device``, else the name of the
    card ``device`` (or the current card) lies on; raises without one."""
    from ..utils.cost import current_card

    if card is not None:
        return card
    if device is not None and str(device).startswith("cpu"):
        return "cpu"
    return current_card(device)


def resolve_peak_tflops(card: str | None = None, device=None) -> float:
    """The roofline's denominator: ``MAGI_ATTENTION_PEAK_TFLOPS`` if set,
    else the CPU placeholder for a CPU ``device``, else ``card``'s (default:
    the card of ``device``, or the current card) datasheet bf16 peak. An
    unknown card raises."""
    from .. import env
    from ..utils.cost import peak_tflops

    if env.peak_tflops_override() is not None:
        return peak_tflops(card)  # the override, whatever the card
    card = _resolve_card(card, device)
    return CPU_PEAK_TFLOPS if card == "cpu" else peak_tflops(card)


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """One workload's mask-aware roofline decomposition."""

    workload: str
    card: str  # the card the peak is for ("cpu": the placeholder)
    peak_tflops: float
    block_q: int
    block_k: int
    head_block: int
    num_heads_q: int
    head_dim: int
    # areas (A <= C <= B), in mask pairs
    mask_area: int  # A: exact valid pairs
    covered_area: int  # C: each q block's covered interval
    tile_area: int  # B: entries * block_q * block_k
    mask_density: float  # A / (Sq * Sk)
    # the grid
    entries: int
    steps: int
    num_q_blocks: int
    grid_rows: int  # heads / head_block
    live_slots: int
    dead_slots: int
    bytes_moved: float  # modeled memory traffic (q/o once, k/v once per entry)
    grid: str = "row_major"  # the sparse grid launches exactly live_slots
    fees: StepFees = StepFees()
    # the measurement (mask-FLOPs convention); None = static analysis
    measured_tflops: float | None = None
    measured_ms: float | None = None

    # -- FLOPs (4 * area * hq * d) -------------------------------------------

    @property
    def mask_flops(self) -> float:
        return 4.0 * self.mask_area * self.num_heads_q * self.head_dim

    @property
    def scheduled_flops(self) -> float:
        return 4.0 * self.tile_area * self.num_heads_q * self.head_dim

    @property
    def overcompute_ratio(self) -> float:
        """Scheduled tile FLOPs / true mask FLOPs (>= 1)."""
        return self.scheduled_flops / max(self.mask_flops, 1.0)

    @property
    def arithmetic_intensity(self) -> float:
        """Scheduled FLOPs per modeled byte: which roof applies."""
        return self.scheduled_flops / max(self.bytes_moved, 1.0)

    # -- modeled seconds -----------------------------------------------------

    def _area_seconds(self, area: float) -> float:
        return 4.0 * area * self.num_heads_q * self.head_dim / (self.peak_tflops * 1e12)

    @property
    def ideal_seconds(self) -> float:
        """Mask FLOPs at peak: the floor (efficiency = ideal / measured)."""
        return self._area_seconds(self.mask_area)

    @property
    def masked_overcompute_seconds(self) -> float:
        return self._area_seconds(self.covered_area - self.mask_area)

    @property
    def partial_tile_seconds(self) -> float:
        return self._area_seconds(self.tile_area - self.covered_area)

    @property
    def dead_step_seconds(self) -> float:
        return self.dead_slots * self.fees.dead_s

    @property
    def live_step_seconds(self) -> float:
        fee = self.fees.live_s + (self.fees.sparse_extra_s if self.grid == "sparse" else 0.0)
        return self.live_slots * fee

    @property
    def modeled_seconds(self) -> float:
        return (self.ideal_seconds + self.masked_overcompute_seconds
                + self.partial_tile_seconds + self.dead_step_seconds + self.live_step_seconds)

    # -- the decomposition ---------------------------------------------------

    @property
    def efficiency(self) -> float | None:
        """The achieved fraction of peak on the true mask FLOPs."""
        if self.measured_tflops is None:
            return None
        return self.measured_tflops / self.peak_tflops

    def gap_fractions(self) -> dict[str, float]:
        """Each waste term's modeled seconds over the gap (measured - ideal
        with a measurement, modeled - ideal without), and the
        ``unattributed`` rest. Where the terms over-price the gap they are
        scaled down together, keeping their shares. Keys: ``dead_steps``,
        ``partial_tile``, ``masked_overcompute``, ``step_overhead``,
        ``unattributed``."""
        total = self.measured_ms * 1e-3 if self.measured_ms is not None else self.modeled_seconds
        gap = max(total - self.ideal_seconds, 1e-30)
        parts = {
            "dead_steps": self.dead_step_seconds,
            "partial_tile": self.partial_tile_seconds,
            "masked_overcompute": self.masked_overcompute_seconds,
            "step_overhead": self.live_step_seconds,
        }
        modeled = sum(parts.values())
        scale = min(gap / modeled, 1.0) if modeled > 0 else 0.0
        out = {k: v * scale / gap for k, v in parts.items()}
        out["unattributed"] = max(1.0 - sum(out.values()), 0.0)
        return out

    @property
    def dominant_waste(self) -> str:
        """The modeled term with the largest share of the gap;
        ``unattributed`` only when every modeled term is about zero."""
        f = self.gap_fractions()
        terms = ("dead_steps", "partial_tile", "masked_overcompute", "step_overhead")
        best = max(terms, key=lambda k: f[k])
        return best if f[best] > 1e-9 else "unattributed"

    def report(self) -> str:
        """The verdict as text: the accounting, then the gap's attribution."""
        lines = [
            f"mask-aware roofline: {self.workload} on {self.card} "
            f"(peak {self.peak_tflops:g} TF/s)",
            f"  rung {self.block_q}x{self.block_k}x{self.head_block} [{self.grid}]: "
            f"{self.entries} entries over {self.num_q_blocks} q-blocks x {self.steps} steps x "
            f"{self.grid_rows} head rows (dead slots {self.dead_slots}/"
            f"{self.dead_slots + self.live_slots})",
            f"  mask density {self.mask_density:.4f}  true {self.mask_flops:.4g} FLOPs vs "
            f"scheduled {self.scheduled_flops:.4g} ({self.overcompute_ratio:.2f}x overcompute)",
            f"  modeled bytes {self.bytes_moved:.4g} "
            f"(intensity {self.arithmetic_intensity:.1f} FLOP/B)",
        ]
        f = self.gap_fractions()
        if self.measured_tflops is not None:
            ms = "-" if self.measured_ms is None else f"{self.measured_ms:.3f}"
            lines.append(f"  measured {self.measured_tflops:.2f} TF/s = {self.efficiency:.1%} of "
                         f"peak (ideal {self.ideal_seconds * 1e3:.3f} ms vs measured {ms} ms)")
        else:
            lines.append(f"  no measurement: attributing the MODELED gap "
                         f"({self.modeled_seconds * 1e3:.3f} ms total, ideal "
                         f"{self.ideal_seconds * 1e3:.3f} ms)")
        lines.append(
            "  gap attribution: "
            f"masked-entry overcompute {f['masked_overcompute']:.1%}, "
            f"partial-tile {f['partial_tile']:.1%}, dead steps {f['dead_steps']:.1%}, "
            f"step overhead {f['step_overhead']:.1%}, unattributed {f['unattributed']:.1%}")
        lines.append(f"  dominant waste term: {self.dominant_waste}")
        return "\n".join(lines)


def _covered_area(q, k, t, block_q: int) -> int:
    """C: over (slice, q block), rows in the block x the exact attended k
    interval."""
    total = 0
    for (q0, q1), (k0, k1), mt in zip(q.tolist(), k.tolist(), t.tolist()):
        if q1 <= q0 or k1 <= k0:
            continue
        _, lo, hi, k_lo, k_hi = slice_block_k_spans(q0, q1, k0, k1, mt, block_q)
        total += int(((hi - lo) * np.maximum(k_hi - k_lo, 0)).sum())
    return total


def analyze_workload(
    q_ranges,
    k_ranges,
    attn_type_map,
    *,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int,
    block_q: int,
    block_k: int,
    head_block: int = 1,
    grid: str = "row_major",
    bytes_per_elt: int = 2,
    card: str | None = None,
    device=None,
    fees: StepFees | None = None,
    workload: str = "workload",
    measured_tflops: float | None = None,
    measured_ms: float | None = None,
    total_seqlen_q: int | None = None,
    total_seqlen_k: int | None = None,
) -> RooflineReport:
    """The static roofline of one workload at one blocking.

    ``grid="sparse"`` has no dead slots (its grid IS the entry list) and
    its live slots pay ``fees.sparse_extra_s`` too. ``card`` / ``device``
    name the peak (:func:`resolve_peak_tflops`). One of ``measured_tflops``
    / ``measured_ms`` (or neither, for a static analysis): the other is
    derived through the mask-FLOPs convention. ``total_seqlen_*`` widen the
    density's dense denominator past the slices' own extent."""
    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    card = _resolve_card(card, device)
    peak = resolve_peak_tflops(card)
    entries, steps, nq = estimate_entries(q, k, t, block_q, block_k)
    area = exact_mask_area(q, k, t)
    covered = _covered_area(q, k, t, block_q)
    tile_area = entries * block_q * block_k
    sq = int(total_seqlen_q) if total_seqlen_q is not None else (int(q[:, 1].max()) if q.size else 0)
    sk = int(total_seqlen_k) if total_seqlen_k is not None else (int(k[:, 1].max()) if k.size else 0)
    grid_rows = max(num_heads_q // max(head_block, 1), 1)
    live = grid_rows * entries
    dead = 0 if grid == "sparse" else max(grid_rows * nq * steps - live, 0)
    # Q read and O written once a row-head; K and V read once an entry
    qo_bytes = 2.0 * sq * num_heads_q * head_dim * bytes_per_elt
    kv_bytes = 2.0 * entries * block_k * num_heads_kv * head_dim * bytes_per_elt
    mask_flops = 4.0 * area * num_heads_q * head_dim
    if measured_tflops is None and measured_ms is not None and measured_ms > 0:
        measured_tflops = mask_flops / (measured_ms * 1e-3) / 1e12
    elif measured_ms is None and measured_tflops:
        measured_ms = mask_flops / (measured_tflops * 1e12) * 1e3
    return RooflineReport(
        workload=workload, card=card, peak_tflops=peak, block_q=block_q, block_k=block_k,
        head_block=head_block, num_heads_q=num_heads_q, head_dim=head_dim, mask_area=area,
        covered_area=covered, tile_area=tile_area,
        mask_density=(area / (sq * sk)) if sq and sk else 0.0, entries=entries, steps=steps,
        num_q_blocks=nq, grid_rows=grid_rows, live_slots=live, dead_slots=dead,
        bytes_moved=qo_bytes + kv_bytes, grid=grid, fees=fees or StepFees(),
        measured_tflops=measured_tflops, measured_ms=measured_ms,
    )


def profile_roofline(
    q_ranges,
    k_ranges,
    attn_type_map=None,
    *,
    num_heads_q: int,
    num_heads_kv: int | None = None,
    head_dim: int,
    block_q: int | None = None,
    block_k: int | None = None,
    head_block: int | None = None,
    grid: str | None = None,
    dtype=None,
    device="cuda",
    card: str | None = None,
    fees: StepFees | None = None,
    workload: str = "workload",
    measured_tflops: float | None = None,
    measured_ms: float | None = None,
    measure: bool = False,
    reps: int = 5,
    warmup: int = 1,
    seed: int = 0,
    record: bool = True,
) -> RooflineReport:
    """Roofline one workload: resolve the blocking the kernel would run
    (``ops.auto_kernel_config``, or the caller's pins; pinned, the grid is
    the caller's, else ``MAGI_ATTENTION_GRID``, else row-major), optionally
    time the flex forward at exactly that blocking (``measure=True``, on
    ``device``: the card unless the caller passes ``"cpu"``; otherwise
    pass ``measured_tflops`` / ``measured_ms``, or get a static analysis),
    and record the ``magi_roofline_*`` gauges. The keyed-runtime entry
    point is ``api.profile_roofline``."""
    import torch

    hkv = num_heads_kv if num_heads_kv is not None else num_heads_q
    dtype = torch.bfloat16 if dtype is None else dtype
    qr = [(int(a), int(b)) for a, b in np.asarray(q_ranges).reshape(-1, 2)]
    kr = [(int(a), int(b)) for a, b in np.asarray(k_ranges).reshape(-1, 2)]
    ts = ([int(x) for x in np.asarray(attn_type_map).reshape(-1)]
          if attn_type_map is not None else [0] * len(qr))
    if block_q is None or block_k is None or head_block is None:
        from ..ops.flex_attn import auto_kernel_config

        bq, bk, hb, ag = auto_kernel_config(
            qr, kr, num_heads_q, hkv, fixed_block_q=block_q, fixed_block_k=block_k,
            attn_type_map=ts, head_dim=head_dim, dtype=str(dtype), grid=grid, device=device)
        block_q, block_k = bq, bk
        head_block = hb if head_block is None else head_block
        grid = ag if grid is None else grid
    if grid is None:
        from .. import env

        grid = env.grid_override() or "row_major"
    if measure:
        measured_ms = _measure_ms(qr, kr, ts, num_heads_q, hkv, head_dim, dtype, device,
                                  block_q=block_q, block_k=block_k, head_block=head_block,
                                  grid=grid, reps=reps, warmup=warmup, seed=seed)
        measured_tflops = None  # re-derived from the mask-FLOPs convention
    rep = analyze_workload(
        qr, kr, ts, num_heads_q=num_heads_q, num_heads_kv=hkv, head_dim=head_dim,
        block_q=block_q, block_k=block_k, head_block=head_block, grid=grid,
        bytes_per_elt=torch.empty((), dtype=dtype).element_size(), card=card, device=device,
        fees=fees, workload=workload, measured_tflops=measured_tflops, measured_ms=measured_ms,
    )
    if record:
        from .collectors import record_roofline

        record_roofline(rep)
    return rep


def device_ms(fn, *, reps: int, warmup: int, inner: int = 1, cuda: bool, group=None) -> float:
    """The median over ``reps`` of ``fn``'s ms per call, ``inner`` calls a
    rep, after ``warmup`` calls. ``cuda``: each rep is timed by CUDA events
    on the current stream, else by the host clock. Without ``group``, a
    spin kernel holds the stream while the host enqueues the rep's calls,
    so a wrapper's host work does not time as launch gaps. With a
    ``torch.distributed`` ``group``, every rank of it calls together: each
    rep starts after a barrier (no spin: the pieces it times wait on the
    other ranks), and the slowest rank's median is returned to all."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    spin_s = None
    if cuda and group is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spin_s = 2 * (time.perf_counter() - t0) * inner + 2e-3
    for _ in range(reps):
        if group is not None:
            import torch.distributed as dist

            if cuda:
                torch.cuda.synchronize()
            dist.barrier(group=group)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin_s is not None:
                torch.cuda._sleep(int(2e9 * spin_s))  # cycles, at most ~2 GHz
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    ms = statistics.median(times)
    if group is not None:
        import torch.distributed as dist

        worst = torch.tensor([ms], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
        ms = float(worst.item())
    return ms


def _measure_ms(qr, kr, ts, hq, hkv, head_dim, dtype, device, *, block_q, block_k, head_block,
                grid, reps, warmup, seed) -> float:
    """The flex forward alone at exactly the priced blocking, on operands
    made from ``seed``, laid out head-major as the kernel takes them (the
    wrapper's transposes are not the kernel's): median ms."""
    import math

    import torch

    from .. import env
    from ..ops import flex_attn as fa

    tq, tk = max(b for _, b in qr), max(b for _, b in kr)
    meta = fa.build_block_meta(qr, kr, ts, tq, tk, block_q=block_q, block_k=block_k)
    dev = str(torch.device(device))
    gen = torch.Generator().manual_seed(seed)

    def rand(h, t, tp):
        x = torch.randn((h, t, head_dim), generator=gen).to(dtype=dtype, device=device)
        return fa._pad_tokens(x, tp)

    tqp, tkp = meta.num_q_blocks * block_q, meta.num_k_blocks * block_k
    q, k, v = rand(hq, tq, tqp), rand(hkv, tk, tkp), rand(hkv, tk, tkp)
    params = fa.FlexAttnParams(block_q=block_q, block_k=block_k, scale=1.0 / math.sqrt(head_dim),
                               softcap=0.0, has_sink=False, out_dtype=dtype,
                               head_block=int(head_block), grid=str(grid))
    work = None
    if grid == "sparse" and q.device.type == "cuda" and env.kernel_backend() == "cuda":
        work = fa.sparse_work(meta, dev, hq, hkv, int(head_block))
    ftab, btab = fa.fwd_tables(meta, dev), fa.bwd_tables(meta, dev)

    def call():
        with torch.no_grad():
            return fa.flex_attn_headmajor(q, k, v, ftab, btab, params, work=work)

    return device_ms(call, reps=reps, warmup=warmup, cuda=q.device.type == "cuda")
