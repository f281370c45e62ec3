"""Reference-style mask workloads: the port's copy of the JAX package's
``testing/workloads.py``, numpy only.

The three dynamic-solver evaluation masks (full causal, varlen block-causal
documents, a shared question with answers that overlap in q). Each builder
returns a list of (q_start, q_end, k_start, k_end, type) slices in global
coordinates, the same lists as the JAX twin for the same arguments.
"""

from __future__ import annotations

import numpy as np


def dense_causal(total: int):
    return [(0, total, 0, total, 1)]


def varlen_block_causal(total: int, n_docs: int = 12, seed: int = 7):
    """Docs of pseudo-random length, each causal over itself."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, total), n_docs - 1, replace=False))
    bounds = [0, *[int(c) for c in cuts], total]
    return [(a, b, a, b, 1) for a, b in zip(bounds, bounds[1:])]


def shared_question_q_overlap(total: int, n_answers: int = 8):
    """A shared question prefix (the first quarter, causal over itself) that
    every answer segment attends fully, plus each answer causal over itself:
    answer q rows appear in two slices."""
    q_len = total // 4
    rest = total - q_len
    seg = rest // n_answers
    slices = [(0, q_len, 0, q_len, 1)]
    for i in range(n_answers):
        a = q_len + i * seg
        b = q_len + (i + 1) * seg if i < n_answers - 1 else total
        slices.append((a, b, 0, q_len, 0))  # full attention to the question
        slices.append((a, b, a, b, 1))  # causal over itself
    return slices


def split_slices(slices):
    """(q_ranges, k_ranges, attn_type_map) of a slice list, as the flex
    entry points take them."""
    return (
        [(int(s[0]), int(s[1])) for s in slices],
        [(int(s[2]), int(s[3])) for s in slices],
        [int(s[4]) for s in slices],
    )


DYNSOLVER_WORKLOADS = {
    "dense_causal": dense_causal,
    "varlen_block_causal": varlen_block_causal,
    "shared_question": shared_question_q_overlap,
}
