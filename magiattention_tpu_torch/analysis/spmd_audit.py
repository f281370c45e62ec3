"""SPMD collective-consistency auditor.

The JAX package's ``analysis/spmd_audit.py``, over the port's collective
recorder. The failure mode this pass exists for is *collective-order
divergence*: one rank issuing a different collective sequence than its
peers — an extra exchange, a mismatched group, a differently shaped
payload — raises nothing anywhere; NCCL (or gloo) blocks every rank inside
a collective its peers never entered. The hop schedules of GroupCast /
GroupReduce make the collective sequence a *planned artifact*, which makes
divergence checkable:

- **Collective signatures.** :func:`collective_signature` turns a rank's
  records (``comm.group_collective.record_collectives``) into its ordered
  sequence of :class:`CollectiveSig`: the op, the axis and size of its
  group, the payload's shape and dtype, and for a ``ppermute`` (one
  ``exchange``) the peer shift as this rank sees it.
- **Cross-rank uniformity.** :func:`audit_uniform` records the sequence
  each rank issues — dry over a ``DryGroup`` in one process (the builder
  takes the rank and rebuilds its comm meta from the shared inputs, so a
  nondeterministic or rank-dependent build shows up as divergence too), or
  live, each rank's records gathered over the group — and asserts the
  signatures are identical, up to the documented per-rank peer.
- **Hop-pairing well-formedness.** :func:`hop_pairing_errors`: rank r's
  k-th ``ppermute`` on a group sends to r + s, so rank r + s's k-th on that
  group must receive from r; every rank of the group must enter the hop
  (a partial hop blocks the absent ranks' peers), and the shift must be one
  uniform rotation. For hop-scheduled metas the recorded shift sequence is
  matched against the meta's active hops, and the reduce direction must
  issue exactly the negated shifts in the same schedule order.

The audited matrix covers every production collective path: flat group
cast / reduce (both impls, dry) across cp, the two-level hierarchical cast
/ reduce (dry, a census per level), the keyed ``dist_attn`` calc and grad
(live over gloo), ``cp_decode`` (live), ``tp_decode_attn`` (one process
over a device list: zero collectives) and the degradation / chaos variants.
:func:`self_test` proves the pass can fail, on plants recorded dry (a live
plant would hang).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .trace_audit import (
    AuditFailure,
    _fmt,
    _pinned_env,
    _pinned_impl,
    collective_census,
    dry_dist_attn,
    expected_plan_cast_collectives,
)

MATRIX_CPS = (1, 2, 4, 8)
HIER_MESHES = ((2, 2), (2, 4))
DIST_ATTN_CASES = ((2, "hops"), (4, "hops"), (4, "a2a"))


@dataclasses.dataclass(frozen=True)
class CollectiveSig:
    """One collective at one schedule position. Equality across ranks is
    the uniformity criterion: same op, same group axis and size, same
    payload, same routing detail, same position in the issue order."""

    op: str
    axis: str
    size: int
    payload: str
    detail: str = ""

    def render(self) -> str:
        d = f" {self.detail}" if self.detail else ""
        return f"{self.op}[{self.axis}/{self.size}] {self.payload}{d}"


def _peer_detail(rec) -> str:
    to, frm = rec.peers
    send, recv = (to - rec.rank) % rec.size, (rec.rank - frm) % rec.size
    if send == recv:
        return f"shift={send}/{rec.size}"
    return f"send+{send},recv-{recv}/{rec.size}"


def collective_signature(records) -> tuple[CollectiveSig, ...]:
    """The ordered collective sequence of one rank's records."""
    return tuple(
        CollectiveSig(r.op, r.axis, r.size, f"{list(r.shape)} {r.dtype}",
                      _peer_detail(r) if r.op == "ppermute" else "")
        for r in records
    )


def signature_shifts(sig: Sequence[CollectiveSig], axis: str | None = None) -> list[int]:
    """The ``shift=k/w`` values of a signature's ppermutes (in schedule
    order), optionally restricted to one axis."""
    out = []
    for s in sig:
        if s.op != "ppermute" or not s.detail.startswith("shift="):
            continue
        if axis is not None and s.axis != axis:
            continue
        out.append(int(s.detail.split("=")[1].split("/")[0]))
    return out


# ---------------------------------------------------------------------------
# hop-pairing well-formedness
# ---------------------------------------------------------------------------


def hop_pairing_errors(rank_records: Sequence[Sequence], groups: dict | None = None) -> list[str]:
    """Pairing checks over every rank's ``ppermute`` records.

    ``rank_records[g]`` are global rank g's records; ``groups`` maps an axis
    to its groups, each the list of global ranks in group-rank order
    (default: one ``cp`` group of every rank). A ppermute ``(r, d)`` is
    group rank r posting a send matched by group rank d's recv at the same
    schedule position on that group: well-formed means every member enters
    the hop, no rank is sent to (or received from) twice, each send is met
    by its peer's recv and the shift is one uniform rotation."""
    if groups is None:
        groups = {"cp": [list(range(len(rank_records)))]}
    errors: list[str] = []
    for axis, members_list in groups.items():
        for members in members_list:
            seqs = {g: [r for r in rank_records[g] if r.op == "ppermute" and r.axis == axis]
                    for g in members}
            depth = max((len(s) for s in seqs.values()), default=0)
            for k in range(depth):
                where = f"ppermute #{k} [{axis} of ranks {members}]"
                present = {i: seqs[g][k] for i, g in enumerate(members) if k < len(seqs[g])}
                if len(present) != len(members):
                    absent = [members[i] for i in range(len(members)) if i not in present]
                    errors.append(f"{where}: {len(present)}/{len(members)} ranks participate: "
                                  f"ranks {absent} never enter the hop and block their peers")
                sends = {i: r.peers[0] for i, r in present.items()}
                recvs = {i: r.peers[1] for i, r in present.items()}
                if len(set(sends.values())) != len(sends):
                    errors.append(f"{where}: a rank is sent to twice ({sorted(sends.items())})")
                if len(set(recvs.values())) != len(recvs):
                    errors.append(f"{where}: a rank is received from twice "
                                  f"({sorted(recvs.items())})")
                one_sided = sorted(i for i, d in sends.items()
                                   if d not in present or recvs[d] != i)
                one_sided += sorted(i for i, s in recvs.items()
                                    if s not in present or sends[s] != i)
                if one_sided:
                    errors.append(f"{where}: sends and recvs do not pair: group ranks "
                                  f"{sorted(set(one_sided))} enter the hop one-sided "
                                  f"(sends {sorted(sends.items())}, recvs "
                                  f"{sorted(recvs.items())})")
                shifts = {(d - i) % len(members) for i, d in sends.items()}
                if len(shifts) > 1:
                    errors.append(f"{where}: mixed shifts {sorted(shifts)}: the hop is not a "
                                  "uniform rotation, so schedule positions disagree across "
                                  "ranks")
    return errors


# ---------------------------------------------------------------------------
# cross-rank uniformity
# ---------------------------------------------------------------------------


def uniformity_errors(label: str, rank_records: Sequence[Sequence],
                      groups: dict | None = None,
                      expect: tuple[CollectiveSig, ...] | None = None
                      ) -> tuple[list[str], tuple[CollectiveSig, ...]]:
    """Every rank's records (``rank_records[g]``) must give one signature,
    and pair their hops (:func:`hop_pairing_errors`). Returns (errors,
    rank-0 signature)."""
    sigs = [collective_signature(r) for r in rank_records]
    errors = [f"{label}: {e}" for e in hop_pairing_errors(rank_records, groups)]
    base = sigs[0]
    for r, sig in enumerate(sigs[1:], 1):
        if sig == base:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(base, sig)) if a != b),
                   min(len(base), len(sig)))
        a = base[pos].render() if pos < len(base) else "<end of schedule>"
        b = sig[pos].render() if pos < len(sig) else "<end of schedule>"
        errors.append(
            f"{label}: rank {r} diverges from rank 0 at schedule position {pos}: "
            f"rank0={a} rank{r}={b}: this hangs (every rank blocks in a collective its "
            "peers never entered)"
        )
    if expect is not None and base != expect:
        errors.append(f"{label}: recorded signature {[s.render() for s in base]} != expected "
                      f"{[s.render() for s in expect]}")
    return errors, base


def audit_uniform(label: str, build: Callable[[int], Sequence], world: int, *,
                  groups: dict | None = None,
                  expect: tuple[CollectiveSig, ...] | None = None
                  ) -> tuple[list[str], tuple[CollectiveSig, ...]]:
    """Record the sequence each rank issues (``build(rank)`` -> its records,
    typically dry) and assert one uniform, well-paired signature. Returns
    (errors, rank-0 signature)."""
    return uniformity_errors(label, [build(r) for r in range(world)], groups, expect)


# ---------------------------------------------------------------------------
# production-path builders
# ---------------------------------------------------------------------------


def _skewed_send_map(cp: int, t: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        [
            rng.choice(t, size=int(rng.integers(0, max(t // 3, 2))), replace=False)
            if s != d
            else np.empty(0, np.int64)
            for d in range(cp)
        ]
        for s in range(cp)
    ]


def _group_records(kind: str, meta, rank: int, cp: int, t: int = 24) -> list:
    """One group cast / reduce_sum / reduce_lse of ``rank``, recorded dry.
    ``t`` must equal the ``num_local_rows`` the meta was built with."""
    import torch

    from ..comm.group_collective import (
        DryGroup,
        group_cast,
        group_reduce_lse,
        group_reduce_sum,
        rank_routing,
        record_collectives,
    )

    rt, g, r_rows = rank_routing(meta, rank, t, "cpu"), DryGroup(rank, cp), meta.max_recv
    with record_collectives("dry") as records:
        if kind == "cast":
            group_cast(torch.zeros((t, 4)), rt, g)
        elif kind == "reduce_sum":
            group_reduce_sum(torch.zeros((r_rows, 4)), rt, g)
        else:
            assert kind == "reduce_lse", kind
            group_reduce_lse(torch.zeros((r_rows, 2, 4)), torch.zeros((r_rows, 2)),
                             torch.zeros((t, 2, 4)), torch.zeros((t, 2)), rt, g)
    return records


def audit_group_matrix(*, cps: Sequence[int] = MATRIX_CPS) -> tuple[list[str], dict]:
    """Per-rank signature uniformity + hop pairing for the flat group
    collectives, both impls, across cp, recorded dry. Each rank REBUILDS
    the meta from the shared send map (every process builds its own routing
    from replicated inputs), so build nondeterminism is divergence too. For
    hops metas the cast's shift sequence must equal the meta's active hops
    and the reduces' the negated shifts in the same order."""
    from ..comm.group_collective import GroupCollectiveMeta

    errors: list[str] = []
    report: dict = {}
    t = 24
    for cp in cps:
        send_map = _skewed_send_map(cp, t, seed=cp)
        # cp=1 goes through the production auto resolution (a zero-volume
        # map resolves to hops = no collective); a2a on one rank is no path
        for impl in (("auto",) if cp == 1 else ("a2a", "hops")):
            meta0 = GroupCollectiveMeta.build(send_map, [t] * cp, impl=impl)
            active = [h.shift for h in meta0.hops if h.shift % cp != 0]
            for kind in ("cast", "reduce_sum", "reduce_lse"):
                label = f"group_{kind} impl={impl} cp={cp}"

                def build(rank, _kind=kind, _impl=impl, _cp=cp):
                    m = GroupCollectiveMeta.build(send_map, [t] * _cp, impl=_impl)
                    return _group_records(_kind, m, rank, _cp, t)

                e, sig = audit_uniform(label, build, cp)
                errors += e
                report[label] = [s.render() for s in sig]
                if cp == 1 and sig:
                    errors.append(f"{label}: cp=1 issued collectives {report[label]}")
                if meta0.impl == "hops":
                    got = signature_shifts(sig, "cp")
                    if kind == "cast":
                        want = list(active)
                    elif kind == "reduce_sum":
                        want = [(-k) % cp for k in active]
                    else:  # reduce_lse reverses the out and the lse payloads
                        want = [(-k) % cp for k in active] * 2
                    if got != want:
                        errors.append(f"{label}: recorded hop shifts {got} != the meta's "
                                      f"schedule {want}: cast and reduce no longer mirror "
                                      "each other")
    return errors, report


class _DryHierGroups:
    """The ``HierCpGroups`` surface a two-level cast reads, over dry groups."""

    def __init__(self, rank: int, n_inter: int, n_intra: int):
        from ..comm.group_collective import DryGroup

        node, intra = divmod(rank, n_intra)
        self.inter = DryGroup(node, n_inter, "inter")
        self.intra = DryGroup(intra, n_intra, "intra")


def hier_groups(n_inter: int, n_intra: int) -> dict:
    """The member lists of each level of an (n_inter, n_intra) layout
    (rank = node * n_intra + intra), in group-rank order."""
    return {
        "inter": [[n * n_intra + i for n in range(n_inter)] for i in range(n_intra)],
        "intra": [[n * n_intra + i for i in range(n_intra)] for n in range(n_inter)],
    }


def audit_hier_matrix(*, meshes: Sequence[tuple[int, int]] = HIER_MESHES,
                      per_rank: bool = True) -> tuple[list[str], dict]:
    """The two-level hierarchical cast / reduce, recorded dry: per-rank
    uniformity and pairing on each level, with the per-level contract — the
    inter level always exactly one ``all_to_all``, the intra level one
    ``all_to_all`` (a2a impl) or exactly the active intra hops as
    ``ppermute`` s (hops impl). ``per_rank=False`` records one rank per case
    (the census without the uniformity sweep)."""
    import torch

    from ..comm.group_collective import record_collectives
    from ..comm.hier import (
        HierGroupCollectiveMeta,
        group_cast_hier,
        group_reduce_hier,
        hier_rank_routing,
    )

    errors: list[str] = []
    report: dict = {}
    t = 16
    for n_inter, n_intra in meshes:
        n = n_inter * n_intra
        send_map = _skewed_send_map(n, t, seed=100 + n)
        for impl in ("a2a", "hops"):
            meta0, _ = HierGroupCollectiveMeta.build(send_map, [t] * n, n_inter, n_intra,
                                                     impl=impl)
            active_intra = [h.shift for h in meta0.intra_hops if h.shift % n_intra != 0]
            for kind in ("cast", "reduce"):
                label = f"hier_{kind} impl={impl} mesh={n_inter}x{n_intra}"

                def build(rank, _impl=impl, _kind=kind):
                    m, _ = HierGroupCollectiveMeta.build(send_map, [t] * n, n_inter, n_intra,
                                                         impl=_impl)
                    hr = hier_rank_routing(m, rank, t, "cpu")
                    groups = _DryHierGroups(rank, n_inter, n_intra)
                    with record_collectives("dry") as records:
                        if _kind == "cast":
                            group_cast_hier(torch.zeros((t, 2)), hr, groups)
                        else:
                            group_reduce_hier(torch.zeros((m.max_recv, 2)), hr, groups)
                    return records

                if per_rank:
                    e, sig = audit_uniform(label, build, n,
                                           groups=hier_groups(n_inter, n_intra))
                else:
                    e, sig = [], collective_signature(build(0))
                errors += e
                report[label] = [s.render() for s in sig]
                inter = [s for s in sig if s.axis == "inter"]
                intra = [s for s in sig if s.axis == "intra"]
                if len(inter) != 1 or inter[0].op != "all_to_all":
                    errors.append(f"{label}: inter level must be exactly one all_to_all, "
                                  f"recorded {[s.render() for s in inter]}")
                if meta0.impl == "hops":
                    if len(intra) != len(active_intra) or any(s.op != "ppermute"
                                                               for s in intra):
                        errors.append(f"{label}: intra level recorded "
                                      f"{[s.render() for s in intra]}, expected "
                                      f"{len(active_intra)} ppermutes (the active intra hops)")
                elif len(intra) != 1 or intra[0].op != "all_to_all":
                    errors.append(f"{label}: intra level must be one all_to_all, recorded "
                                  f"{[s.render() for s in intra]}")
    return errors, report


# ---------------------------------------------------------------------------
# live paths (one RankPool; rank functions importable from here)
# ---------------------------------------------------------------------------


def _case_group(group, cp: int):
    """The first ``cp`` ranks of the pool as a group (every rank must join
    ``new_group``), or the pool's group when it has exactly ``cp`` ranks;
    None on ranks outside the case."""
    import torch.distributed as dist

    if dist.get_world_size(group) == cp:
        return group
    sub = dist.new_group(list(range(cp)))
    return sub if dist.get_rank(group) < cp else None


def _gather_records(records, group) -> list:
    import torch.distributed as dist

    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, list(records), group=group)
    return every


def dist_attn_rank(group, cp: int, impl: str, total: int = 512, chunk: int = 64,
                   heads=(2, 2), head_dim: int = 64, chaos: str = "",
                   degree: int = 0) -> dict | None:
    """One rank of the keyed calc and grad on the CPU, recorded live: the
    causal mask of ``total`` tokens at cp ``cp`` and overlap ``degree``
    under a pinned impl (and a chaos spec). Returns every rank's forward and forward + backward records
    (gathered over the case's group), the plan's expectation and this rank's
    dry records of the same plan, or None on a rank outside the case."""
    import torch
    import torch.distributed as dist

    from .. import api
    from ..comm.group_collective import record_collectives
    from ..config import DistAttnConfig
    from ..meta.solver.overlap_solver import OverlapConfig
    from ..resilience import reset_chaos

    sub = _case_group(group, cp)
    if sub is None:
        return None
    hq, hk = heads
    config = DistAttnConfig(overlap_config=OverlapConfig(degree=degree, min_stage_rows=64))
    with _pinned_impl(impl), _pinned_env("MAGI_ATTENTION_CHAOS", chaos or None):
        reset_chaos()
        api.clear_cache()
        try:
            key = api.magi_attn_flex_key([(0, total)], [(0, total)], [1], total, total, sub,
                                         num_heads=(hq, hk), head_dim=head_dim,
                                         chunk_size=chunk, dist_attn_config=config,
                                         device="cpu")
            plan = api.get_runtime_mgr(key).plan
            gen = torch.Generator().manual_seed(0)
            q, k, v = (torch.randn((total, h, head_dim), generator=gen).to(torch.bfloat16)
                       for h in (hq, hk, hk))
            qd, kd, vd = (api.dispatch(x, key).detach().requires_grad_() for x in (q, k, v))
            with record_collectives("live") as fwd:
                out, _ = api.calc_attn(qd, kd, vd, key)
            fwd = list(fwd)
            with record_collectives("live") as bwd:
                out.float().sum().backward()
        finally:
            api.clear_cache()
            reset_chaos()
    rank = dist.get_rank(sub)
    dry = dry_dist_attn(plan, rank, heads=heads, head_dim=head_dim)[0]
    return {"rank": rank, "fwd": _gather_records(fwd, sub),
            "fwd_bwd": _gather_records(fwd + list(bwd), sub),
            "expected_fwd": expected_plan_cast_collectives(plan), "dry": dry,
            "overlap_degree": plan.overlap_degree, "impls": [c.impl for c in plan.comms()]}


def live_dist_attn_errors(label: str, results: list, impl: str) -> tuple[list[str], list]:
    """The checks of one :func:`dist_attn_rank` case: uniform, well-paired
    forward and forward + backward signatures; census = the plan's
    expectation (twice it for forward and backward); each rank's live
    records equal its dry ones; a hops-pinned plan issues no all_to_all."""
    res = [r for r in results if r is not None]
    errors: list[str] = []
    fwd, both = res[0]["fwd"], res[0]["fwd_bwd"]
    e, _ = uniformity_errors(f"{label} calc", fwd)
    errors += e
    e, sig = uniformity_errors(f"{label} grad", both)
    errors += e
    expect = res[0]["expected_fwd"]
    for rank, (f, b) in enumerate(zip(fwd, both)):
        if collective_census(f) != expect:
            errors.append(f"{label} rank {rank}: calc census {_fmt(collective_census(f))} != "
                          f"CommMeta expectation {_fmt(expect)}")
        want2 = {op: 2 * c for op, c in expect.items()}
        if collective_census(b) != want2:
            errors.append(f"{label} rank {rank}: calc+grad census "
                          f"{_fmt(collective_census(b))} != 2x cast expectation {_fmt(want2)}")
    for r in res:
        live = collective_signature(both[r["rank"]])
        if collective_signature(r["dry"]) != live:
            errors.append(f"{label} rank {r['rank']}: live records "
                          f"{[s.render() for s in live]} != dry "
                          f"{[s.render() for s in collective_signature(r['dry'])]}")
    if impl == "hops" and any(s.op == "all_to_all" for s in sig):
        errors.append(f"{label}: hops-pinned plan issued an all_to_all")
    return errors, [s.render() for s in sig]


def audit_dist_attn_matrix(pool, *, total: int = 512, chunk: int = 64,
                           cases=DIST_ATTN_CASES) -> tuple[list[str], dict]:
    """Per-rank uniformity of the keyed ``dist_attn`` calc + grad (causal
    plan, pinned hops and a2a impls), live over gloo in ``pool`` (a
    ``testing.dist.RankPool`` of at least the largest cp): every rank's
    records gathered and compared, each against its dry record."""
    errors: list[str] = []
    report: dict = {}
    for cp, impl in cases:
        label = f"dist_attn cp={cp} impl={impl}"
        e, sig = live_dist_attn_errors(label, pool.run(dist_attn_rank, cp, impl, total, chunk),
                                       impl)
        errors += e
        report[label] = sig
    return errors, report


def cp_decode_rank(group, cp: int) -> list | None:
    """One rank of ``cp_decode_attn`` on the CPU, recorded live: every
    rank's records (None on a rank outside the case)."""
    import torch

    from ..comm.group_collective import record_collectives
    from ..serving.cp_decode import cp_decode_attn
    from ..serving.kv_cache import assign_block_table, make_paged_kv_cache

    sub = _case_group(group, cp)
    if sub is None:
        return None
    cache = make_paged_kv_cache(4, 8, 2, 16, max_seqs=2, max_pages_per_seq=2,
                                dtype=torch.float32, device="cpu")
    assign_block_table(cache, 0, [1, 2], keep_len=11)
    assign_block_table(cache, 1, [3], keep_len=5)
    q = torch.zeros((2, 2, 16))
    with record_collectives("live") as records:
        cp_decode_attn(q, cache, torch.tensor([0, 1]), group=sub, cp_size=cp)
    return _gather_records(records, sub)


def audit_cp_decode(pool=None, *, cps: Sequence[int] = (1, 2, 4)) -> tuple[list[str], dict]:
    """``cp_decode_attn``: per-rank uniformity; the cross-rank merge is
    exactly two ``all_gather`` s (out + lse partials) and cp=1 issues
    nothing. Live over gloo in ``pool``; cp=1 (and every cp without a pool)
    dry, one ``DryGroup`` a rank."""
    import torch

    from ..comm.group_collective import DryGroup, record_collectives
    from ..serving.cp_decode import cp_merge_partials

    errors: list[str] = []
    report: dict = {}
    for cp in cps:
        label = f"cp_decode cp={cp}"
        if pool is not None and cp > 1:
            rank_records = next(r for r in pool.run(cp_decode_rank, cp) if r is not None)
        else:
            rank_records = []
            for rank in range(cp):
                with record_collectives("dry") as records:
                    cp_merge_partials(torch.zeros((2, 2, 16)), torch.zeros((2, 2)),
                                      group=DryGroup(rank, cp), cp_size=cp)
                rank_records.append(records)
        e, sig = uniformity_errors(label, rank_records)
        errors += e
        report[label] = [s.render() for s in sig]
        ops = [s.op for s in sig]
        if cp == 1 and sig:
            errors.append(f"{label}: cp=1 must issue no collective, got {report[label]}")
        elif cp > 1 and ops != ["all_gather", "all_gather"]:
            errors.append(f"{label}: expected exactly two all_gathers (out + lse partials), "
                          f"recorded {report[label]}")
    return errors, report


def audit_tp_decode(*, tps: Sequence[int] = (1, 2, 4)) -> tuple[list[str], dict]:
    """TP decode must issue ZERO collectives at every width: it runs in one
    process over a device list, each head slice's launch on its own shard,
    softmax per head, so the KV-head-sharded layout's bitwise-parity claim
    has this structural half."""
    import torch

    from ..comm.group_collective import record_collectives
    from ..serving.distributed import tp_decode_attn
    from ..serving.kv_cache import assign_block_table, make_paged_kv_cache, shard_kv_cache

    errors: list[str] = []
    report: dict = {}
    for tp in tps:
        label = f"tp_decode tp={tp}"
        devices = ["cpu"] * tp
        cache = make_paged_kv_cache(4, 8, 4, 16, max_seqs=2, max_pages_per_seq=2,
                                    dtype=torch.bfloat16, device="cpu")
        assign_block_table(cache, 0, [1, 2], keep_len=11)
        if tp > 1:
            cache = shard_kv_cache(cache, devices)
        q = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
        with record_collectives("dry") as records:
            tp_decode_attn(q, cache, [0, 1], devices=devices, num_splits=2)
        report[label] = [s.render() for s in collective_signature(records)]
        if records:
            errors.append(f"{label}: the KV-head-sharded decode issued {report[label]}: zero "
                          "collectives may cross the head axis")
    return errors, report


def audit_variants(pool=None, *, cp: int = 4) -> tuple[list[str], dict]:
    """Degradation and chaos variants stay uniform.

    - With ``hops_build_error`` chaos armed per rank's build, EVERY rank's
      meta degrades to the a2a fallback: the signatures stay uniform and
      are the single a2a (dry).
    - Live in ``pool``: the keyed plan under ``plan_error`` degrades to
      degree 0 on every rank alike, and the rank-gated corruption and the
      straggler of ``corrupt_cast:value=nan,rank=0;straggler:hop=1`` change
      values and timing, never the schedule."""
    from ..comm.group_collective import GroupCollectiveMeta
    from ..resilience import reset_chaos

    errors: list[str] = []
    report: dict = {}
    t = 24
    send_map = _skewed_send_map(cp, t, seed=7)
    label = f"degraded_hops_build cp={cp}"

    def build_degraded(rank):
        with _pinned_env("MAGI_ATTENTION_CHAOS", "hops_build_error"):
            reset_chaos()  # re-arm for THIS rank's build
            meta = GroupCollectiveMeta.build(send_map, [t] * cp, impl="hops")
        reset_chaos()
        if meta.impl != "a2a":
            raise AuditFailure(f"{label}: chaos-failed hops build did not degrade to a2a "
                                 f"(impl={meta.impl})")
        return _group_records("cast", meta, rank, cp, t)

    e, sig = audit_uniform(label, build_degraded, cp)
    errors += e
    report[label] = [s.render() for s in sig]
    if [s.op for s in sig] != ["all_to_all"]:
        errors.append(f"{label}: degraded cast must be the single a2a, recorded "
                      f"{report[label]}")
    if pool is not None:
        for name, spec in (("plan_error", "plan_error:times=1"),
                           ("chaos_in_graph", "corrupt_cast:value=nan,rank=0;straggler:hop=1")):
            label = f"{name} cp=2"
            results = pool.run(dist_attn_rank, 2, "hops", 512, 64, (2, 2), 64, spec, 1)
            res = [r for r in results if r is not None]
            e, sig = uniformity_errors(label, res[0]["fwd_bwd"])
            errors += e
            report[label] = [s.render() for s in sig]
            if name == "plan_error" and any(r["overlap_degree"] != 0 for r in res):
                errors.append(f"{label}: a rank's plan did not degrade to degree 0")
    return errors, report


def run_full_audit(pool=None) -> tuple[list[str], dict]:
    """The whole matrix (the CLI's spmd pass): the live parts run in
    ``pool`` (a 4-rank ``RankPool``), the rest dry."""
    errors: list[str] = []
    report: dict = {}
    parts = [audit_group_matrix, audit_hier_matrix, audit_tp_decode]
    parts += [lambda: audit_cp_decode(pool), lambda: audit_variants(pool)]
    if pool is not None:
        parts.append(lambda: audit_dist_attn_matrix(pool))
    for fn in parts:
        e, r = fn()
        errors += e
        report.update(r)
    return errors, report


# ---------------------------------------------------------------------------
# self-test plants (dry: a live plant would hang)
# ---------------------------------------------------------------------------


def _plant_records(world: int, issue: Callable) -> list:
    """Each rank's dry records of ``issue(rank, group)``."""
    from ..comm.group_collective import DryGroup, record_collectives

    out = []
    for rank in range(world):
        with record_collectives("dry") as records:
            issue(rank, DryGroup(rank, world))
        out.append(records)
    return out


def self_test() -> list[str]:
    """Prove the pass can fail: a rank-gated extra ppermute must break
    uniformity, and a one-sided and a mixed-shift permutation must break
    hop pairing."""
    import torch

    from ..comm.group_collective import exchange

    errors: list[str] = []
    x = torch.zeros((4,))

    def gated(rank, g):
        exchange(x, (rank + 1) % 2, (rank - 1) % 2, g)
        if rank == 0:  # the planted host divergence
            exchange(x, 1, 1, g)

    e, _ = uniformity_errors("planted rank-gated ppermute", _plant_records(2, gated))
    if not any("diverges from rank 0" in m for m in e):
        errors.append(f"self-test: planted rank-gated extra ppermute NOT flagged (errors={e})")

    def one_sided(rank, g):
        if rank == 0:  # rank 1 never sends: rank 0's send has no matching recv
            exchange(x, 1, 1, g)

    if not hop_pairing_errors(_plant_records(2, one_sided)):
        errors.append("self-test: planted one-sided perm passed hop pairing")

    def mixed(rank, g):
        # ranks 0, 1 rotate by one, ranks 2, 3 by two: positions disagree
        s = 1 if rank < 2 else 2
        exchange(x, (rank + s) % 4, (rank - s) % 4, g)

    if not any("mixed shifts" in m or "do not pair" in m
               for m in hop_pairing_errors(_plant_records(4, mixed))):
        errors.append("self-test: planted mixed-shift perm passed hop pairing")
    return errors
