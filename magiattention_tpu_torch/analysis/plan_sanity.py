"""Structural plan sanitizer (``MAGI_ATTENTION_VALIDATE``).

The JAX package's ``analysis/plan_sanity.py``, over the port's planning
artifacts: ``AttnSlice`` lists, ``GroupCollectiveMeta`` /
``HierGroupCollectiveMeta`` routing tables and ``DistAttnPlan`` stage and
area accounting. Each check is a numpy assertion over host tables that
already exist; nothing runs on a device. Every check and every message is
the JAX package's.

Activation (``env.validate_mode``), wired at the end of
``parallel/dist_attn.py::build_dist_attn_plan``:

- ``off`` (default): the plan-build hook is a single predicate call;
- ``plan``: every built plan runs through :func:`validate_plan` before it
  is returned;
- ``trace``: ``plan``, then the plan's collective audit
  (``analysis.trace_audit.audit_plan_collectives``).

Failures raise :class:`PlanValidationError` and tick the
``magi_validate_failures`` counter (``magi_validate_plan_checks`` counts
every completed ``validate_plan`` call, and every failure), so a fleet can
alarm on validation hits without scraping logs.
"""

from __future__ import annotations

import numpy as np

from ..telemetry import collectors as _collectors


class PlanValidationError(AssertionError):
    """A planning artifact violated a structural invariant."""


def _fail(msg: str) -> None:
    _collectors.record_validate(failed=True)
    raise PlanValidationError(msg)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


# ---------------------------------------------------------------------------
# AttnSlices
# ---------------------------------------------------------------------------


def validate_slices(slices, total_q: int, total_k: int) -> None:
    """Every slice's q/k ranges in-bounds and well-formed for its mask
    type (``slices``: iterable of AttnSlice, or (qs, qe, ks, ke, type)
    tuples).

    Mask-type well-formedness (see common/enum.py semantics): a causal
    (bottom-right aligned) band needs its last q row to see a non-empty
    k interval; an inv-causal (top-left aligned) band needs the same of
    its first row; bicausal needs the band to stay non-empty across the
    whole q interval — i.e. the k range must be at least as tall as the
    q range."""
    for i, s in enumerate(slices):
        if hasattr(s, "q_range"):
            qs, qe = s.q_range.start, s.q_range.end
            ks, ke = s.k_range.start, s.k_range.end
            mt = int(s.mask_type)
        else:
            qs, qe, ks, ke, mt = (int(v) for v in s)
        _check(
            0 <= qs < qe <= total_q,
            f"slice {i}: q_range [{qs},{qe}) out of bounds for "
            f"total_seqlen_q={total_q}",
        )
        _check(
            0 <= ks < ke <= total_k,
            f"slice {i}: k_range [{ks},{ke}) out of bounds for "
            f"total_seqlen_k={total_k}",
        )
        _check(mt in (0, 1, 2, 3), f"slice {i}: unknown mask type {mt}")
        if mt == 3:  # bicausal: both bounds active over the whole band
            _check(
                ke - ks >= qe - qs,
                f"slice {i}: bicausal slice with k span {ke - ks} < q span "
                f"{qe - qs} has empty rows",
            )


# ---------------------------------------------------------------------------
# GroupCollectiveMeta
# ---------------------------------------------------------------------------


def _validate_hier_comm_meta(comm) -> None:
    """Reduced checks for the two-level ``HierGroupCollectiveMeta`` (its
    routing is split across an inter and an intra hop, so the flat
    permutation check does not apply): totals consistent, table shapes
    coherent, intra hops padded."""
    n = comm.n_inter * comm.n_intra
    _check(
        comm.n_inter >= 1 and comm.n_intra >= 1,
        f"hier mesh shape ({comm.n_inter}, {comm.n_intra}) invalid",
    )
    _check(
        len(comm.recv_total) == n,
        f"hier recv_total has {len(comm.recv_total)} entries != "
        f"{n} ranks",
    )
    _check(
        np.asarray(comm.inter_send_idx).shape[0] == n
        and np.asarray(comm.intra_send_idx).shape[0] == n,
        "hier routing tables disagree with the rank count",
    )
    _check(
        all(t >= 0 for t in comm.recv_total)
        and all(t >= 0 for t in comm.inter_rows_total),
        "hier row totals must be non-negative",
    )
    R = comm.max_recv
    _check(
        all(t <= R for t in comm.recv_total),
        f"hier recv_total exceeds the padded recv extent {R}",
    )
    for h in comm.intra_hops:
        _check(
            h.size % comm.pad_to == 0,
            f"hier intra hop {h.shift} size {h.size} not padded to "
            f"pad_to={comm.pad_to}",
        )


def validate_comm_meta(comm, num_local_rows: int | None = None) -> None:
    """Routing-table invariants of one ``GroupCollectiveMeta``.

    - the recv layout is a true permutation: each dst's valid
      ``recv_sel`` entries are DISTINCT flat (src * S + pos) indices,
      exactly ``recv_total[dst]`` of them, and every referenced pos is a
      really-sent row (pos < that pair's send count is implied by
      distinctness + counts on the canonical builder; OOB flat indices
      are checked explicitly);
    - volume accounting is ordered: scheduled >= true-on-the-wire >=
      0 and true >= local >= 0 (hop scheduling moves local rows by copy,
      the a2a ships them padded — both must still dominate the real
      payload);
    - hop plans (impl == 'hops') cover each wire pair exactly once and
      pad to the meta's ``pad_to``.

    Hierarchical (two-level) metas take the reduced
    :func:`_validate_hier_comm_meta` path — their routing is split
    across the inter and intra hops, so the flat checks don't apply.
    """
    if not hasattr(comm, "cp_size"):  # HierGroupCollectiveMeta
        _validate_hier_comm_meta(comm)
        return
    cp, S, R = comm.cp_size, comm.max_send, comm.max_recv
    send_idx = np.asarray(comm.send_idx)
    recv_sel = np.asarray(comm.recv_sel)
    _check(cp >= 1, f"cp_size {cp} < 1")
    _check(
        send_idx.shape == (cp, cp, S),
        f"send_idx shape {send_idx.shape} != {(cp, cp, S)}",
    )
    _check(
        recv_sel.shape == (cp, R),
        f"recv_sel shape {recv_sel.shape} != {(cp, R)}",
    )
    if num_local_rows is not None:
        _check(
            int(send_idx.max(initial=0)) < max(num_local_rows, 1),
            "send_idx references a row >= num_local_rows "
            f"({int(send_idx.max(initial=0))} >= {num_local_rows})",
        )

    # recv layout: a true permutation of sent rows
    trash = cp * S
    for d in range(cp):
        valid = np.asarray(comm.recv_valid[d], dtype=bool)
        sel = recv_sel[d][valid]
        _check(
            sel.size == comm.recv_total[d],
            f"dst {d}: {sel.size} valid recv slots != recv_total "
            f"{comm.recv_total[d]}",
        )
        _check(
            sel.size == np.unique(sel).size,
            f"dst {d}: recv_sel repeats a source row — recv layout is "
            "not a permutation",
        )
        if sel.size:
            _check(
                int(sel.min()) >= 0 and int(sel.max()) < trash,
                f"dst {d}: recv_sel references flat index outside "
                f"[0, {trash})",
            )
        # pads must aim at the trash slot so reverse scatters stay inert
        pads = recv_sel[d][~valid]
        _check(
            bool((pads == trash).all()),
            f"dst {d}: pad recv slots must point at the trash slot {trash}",
        )

    # volume ordering
    true_rows = comm.true_rows_total
    local_rows = comm.local_rows_total
    _check(
        0 <= local_rows <= true_rows,
        f"local rows {local_rows} outside [0, true rows {true_rows}]",
    )
    wire_true = true_rows - local_rows if comm.impl == "hops" else true_rows
    _check(
        comm.scheduled_rows_total >= wire_true,
        f"scheduled rows {comm.scheduled_rows_total} < wire-true rows "
        f"{wire_true} — impl claims to move fewer rows than the plan "
        "routes",
    )
    _check(
        sum(comm.send_total) == sum(comm.recv_total),
        f"send_total sum {sum(comm.send_total)} != recv_total sum "
        f"{sum(comm.recv_total)}",
    )

    if comm.impl == "hops":
        shifts = [h.shift for h in comm.hops]
        _check(
            len(shifts) == len(set(shifts)),
            f"duplicate hop shifts {shifts}",
        )
        for h in comm.hops:
            _check(
                0 <= h.shift < cp,
                f"hop shift {h.shift} outside [0, cp={cp})",
            )
            _check(
                h.size % comm.pad_to == 0,
                f"hop {h.shift} size {h.size} not padded to pad_to="
                f"{comm.pad_to}",
            )
            _check(
                np.asarray(h.send_idx).shape == (cp, h.size)
                and np.asarray(h.recv_pos).shape == (cp, h.size),
                f"hop {h.shift} table shapes inconsistent with size "
                f"{h.size}",
            )
            rp = np.asarray(h.recv_pos)
            _check(
                bool(((rp >= 0) & (rp <= R)).all()),
                f"hop {h.shift} recv_pos outside [0, R={R}]",
            )


# ---------------------------------------------------------------------------
# DistAttnPlan
# ---------------------------------------------------------------------------


def validate_plan(plan, *, total_area: int | None = None) -> None:
    """Whole-plan invariants; ``total_area`` (the source bucket's mask
    area) enables the exact area-accounting check at build time.

    Records one ``magi_validate_plan_checks`` tick per completed call.
    """
    cp = plan.cp_size
    _check(cp >= 1, f"plan cp_size {cp} < 1")
    _check(
        plan.shard_q_len <= plan.shard_q_pad,
        f"shard_q_len {plan.shard_q_len} > shard_q_pad {plan.shard_q_pad}",
    )
    _check(
        plan.shard_q_pad % plan.block_q == 0,
        f"shard_q_pad {plan.shard_q_pad} not a block_q={plan.block_q} "
        "multiple",
    )
    if total_area is not None:
        _check(
            plan.total_area == total_area,
            f"plan total_area {plan.total_area} != mask area {total_area}",
        )
    _check(
        0 <= plan.max_rank_area <= plan.total_area,
        f"max_rank_area {plan.max_rank_area} outside [0, total_area "
        f"{plan.total_area}]",
    )
    _check(
        plan.max_rank_area * cp >= plan.total_area,
        f"max_rank_area {plan.max_rank_area} * cp {cp} < total_area "
        f"{plan.total_area} — some area is unassigned (max >= mean must "
        "hold)",
    )

    if plan.overlap_degree == 0:
        _check(
            plan.merged_comm is not None and plan.merged_tables is not None,
            "degree-0 plan missing merged comm/tables",
        )
        validate_comm_meta(plan.merged_comm)
    else:
        _check(
            plan.host_tables is not None,
            "staged plan missing host tables",
        )
        _check(
            len(plan.stages) <= plan.overlap_degree,
            f"{len(plan.stages)} stages > overlap_degree "
            f"{plan.overlap_degree}",
        )
        stage_sum = plan.host_max_rank_area + sum(
            sp.max_rank_area for sp in plan.stages
        )
        # per-stage maxima bracket the critical rank's area: their sum can
        # only exceed total_area if some area is double-counted across
        # stages, and can only undershoot max_rank_area if a stage lost
        # area (each rank's total is <= the sum of per-stage maxima)
        _check(
            stage_sum <= plan.total_area,
            f"host+stage max areas sum to {stage_sum} > total_area "
            f"{plan.total_area} — a stage double-counts mask area",
        )
        _check(
            stage_sum >= plan.max_rank_area,
            f"host+stage max areas sum to {stage_sum} < max_rank_area "
            f"{plan.max_rank_area} — a stage lost mask area",
        )
        for i, sp in enumerate(plan.stages):
            # a two-level stage meta counts its ranks as n_inter * n_intra
            # (the JAX package reads a cp_size it does not have there)
            stage_cp = getattr(sp.comm, "cp_size", None)
            if stage_cp is None:
                stage_cp = sp.comm.n_inter * sp.comm.n_intra
            _check(
                stage_cp == cp,
                f"stage {i} comm cp {stage_cp} != plan cp {cp}",
            )
            _check(
                any(t > 0 for t in sp.comm.recv_total),
                f"stage {i} moves zero rows — empty stages must be "
                "filtered at build time",
            )
            validate_comm_meta(sp.comm)
    _collectors.record_validate(failed=False)
