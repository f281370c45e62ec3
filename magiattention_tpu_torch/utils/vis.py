"""Attention-plane pictures for plan debugging: the port's twin of the JAX
package's ``utils/vis.py`` (the reference's dynamic-solver bucket plot):
a dynamic-solver rank partition, or any slice-list mask, drawn to a PNG as
exact polygons.

matplotlib is imported lazily and used through its object-oriented
``Figure`` API with an Agg canvas, so the process-wide pyplot backend is
never touched; without matplotlib (the machine with the card has none)
each function logs a warning and does nothing.
"""

from __future__ import annotations

from typing import Sequence


def _figure(figsize):
    try:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        fig = Figure(figsize=figsize)
        FigureCanvasAgg(fig)  # attaches itself as fig.canvas
        return fig
    except ImportError:
        import logging

        logging.getLogger("magiattention_tpu_torch").warning(
            "matplotlib unavailable; skipping visualization"
        )
        return None


def _tab10(i: int):
    from matplotlib import colormaps

    return colormaps["tab10"](i % 10)


def _mask_polygon(qs, qe, ks, ke, mask_type):
    """Vertices of the unmasked region of one slice in (k, q) plot coords.

    Uses the slice alignment conventions of common/mask.py: a causal
    bound is the bottom-right diagonal (row q sees k < ke - (qe - 1 - q)),
    an inv-causal bound the top-left diagonal (k >= ks + q - qs).
    """
    from ..common.enum import AttnMaskType

    mt = AttnMaskType(int(mask_type))
    sq = qe - qs
    pts_left = []
    pts_right = []
    for q in (qs, qe):  # corners suffice: bounds are linear in q
        i = q - qs
        lo = ks + (i if mt.is_inv_causal_bound else 0)
        hi = ke - (sq - i) + 1 if mt.is_causal_bound else ke
        lo = min(max(lo, ks), ke)
        hi = min(max(hi, ks), ke)
        pts_left.append((lo, q))
        pts_right.append((hi, q))
    # polygon: left edge top->bottom, right edge bottom->top
    return pts_left + pts_right[::-1]


def plot_mask(
    q_ranges,
    k_ranges,
    attn_type_map: Sequence[int],
    total_q: int,
    total_k: int,
    save_path: str,
    title: str = "attention mask",
) -> str | None:
    """Render a slice-list mask as exact polygons (no dense materialization,
    so 1M-token masks plot fine)."""
    fig = _figure((6, 6))
    if fig is None:
        return None
    from ..common.ranges import AttnRanges

    if isinstance(q_ranges, AttnRanges):
        q_ranges = q_ranges.to_naive_ranges()
    if isinstance(k_ranges, AttnRanges):
        k_ranges = k_ranges.to_naive_ranges()
    ax = fig.add_subplot()
    for j, ((qs, qe), (ks, ke), mt) in enumerate(
        zip(q_ranges, k_ranges, attn_type_map)
    ):
        poly = _mask_polygon(qs, qe, ks, ke, mt)
        ax.fill(
            [p[0] for p in poly],
            [p[1] for p in poly],
            color=_tab10(j),
            alpha=0.55,
            linewidth=0.5,
            edgecolor="black",
        )
    ax.set_xlim(0, total_k)
    ax.set_ylim(total_q, 0)  # row 0 on top, like a matrix
    ax.set_xlabel("k")
    ax.set_ylabel("q")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    return save_path


def plot_dynamic_solution(
    solution,
    total_q: int,
    total_k: int,
    save_path: str,
) -> str | None:
    """Render a DynamicAttnSolution: each rank's rectangles in one color,
    with the per-rank area share in the legend (reference
    dynamic_solver_vis.py bucket plot)."""
    fig = _figure((7, 6))
    if fig is None:
        return None
    ax = fig.add_subplot()
    areas = solution.areas
    total = max(sum(areas), 1)
    for r, rects in enumerate(solution.rank_rects):
        color = _tab10(r)
        first = True
        for rect in rects:
            poly = _mask_polygon(
                rect.q_range.start,
                rect.q_range.end,
                rect.k_range.start,
                rect.k_range.end,
                rect.mask_type,
            )
            ax.fill(
                [p[0] for p in poly],
                [p[1] for p in poly],
                color=color,
                alpha=0.6,
                linewidth=0.4,
                edgecolor="black",
                label=f"rank {r}: {areas[r] / total:.1%}" if first else None,
            )
            first = False
    ax.set_xlim(0, total_k)
    ax.set_ylim(total_q, 0)
    ax.set_xlabel("k")
    ax.set_ylabel("q")
    ax.set_title(
        f"dynamic partition: balance={solution.balance_ratio:.3f}"
    )
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    return save_path
