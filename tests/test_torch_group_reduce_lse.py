"""The port's GroupReduce with the LSE op (``comm.group_reduce_lse``) over
gloo against the JAX package's ``group_reduce_lse_m`` in a ``shard_map`` on
its virtual CPU mesh, a2a and hops, cp 2 and 4: a random send map whose
partials hold -inf lse entries, accumulators with -inf rows, and rows no
one contributes to, which must stay (0, -inf). The merged out and lse and
the gradients of every input (of sum(out**2) + sum(finite lse)) within
rtol 1e-5 / atol 1e-6 (the same two-pass formulas in float32, summed in
another order), every gradient finite. A planted reduce that drops the
partials of other ranks must fail the comparison."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magiattention_tpu.comm.group_collective import GroupCollectiveMeta as JaxGCM
from magiattention_tpu.comm.group_collective import group_reduce_lse_m
from magiattention_tpu.utils.compat import shard_map
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers


def _mesh(cp):
    return Mesh(np.array(jax.devices()[:cp]), ("cp",))


@pytest.fixture(scope="module")
def pools():
    pools = {cp: RankPool(cp) for cp in (2, 4)}
    yield pools
    for p in pools.values():
        p.close()


ROWS, H, DF = 16, 2, 4


def _reduce_operands(cp, seed=7):
    """A random send map that leaves rows 12-15 of every rank unsent, its
    partials with -inf lse entries (0 out), and accumulators whose rows 0-1
    and 12-13 are -inf: rows 12-13 get no contribution at all."""
    rng = np.random.default_rng(seed)
    send_map = [[np.sort(rng.choice(12, int(rng.integers(0, 9)), replace=False))
                 for _ in range(cp)] for _ in range(cp)]
    r = JaxGCM.build(send_map, [ROWS] * cp, impl="a2a").max_recv
    op = rng.standard_normal((cp, r, H, DF)).astype(np.float32)
    lp = (3 * rng.standard_normal((cp, r, H))).astype(np.float32)
    dead = rng.random((cp, r, H)) < 0.2
    lp[dead] = -np.inf
    op[dead] = 0.0
    oa = rng.standard_normal((cp, ROWS, H, DF)).astype(np.float32)
    la = rng.standard_normal((cp, ROWS, H)).astype(np.float32)
    la[:, [0, 1, 12, 13]] = -np.inf
    oa[:, [0, 1, 12, 13]] = 0.0
    return send_map, dict(op=op, lp=lp, oa=oa, la=la)


def _jax_reduce(send_map, ops, cp, impl):
    mesh = _mesh(cp)
    jm = JaxGCM.build(send_map, [ROWS] * cp, impl=impl)

    arrays = [jax.device_put(a, NamedSharding(mesh, P("cp"))) for a in jm.reduce_device_arrays()]

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("cp"),) * (4 + len(arrays)),
                       out_specs=(P("cp"), P("cp")), check_vma=False)
    def red(op, lp, oa, la, *arrs):
        return group_reduce_lse_m(op, lp, oa, la, jm, arrs, axis_name="cp")

    def loss(*xs):
        o, lse = red(*xs, *arrays)
        return (o ** 2).sum() + jnp.where(jnp.isfinite(lse), lse, 0.0).sum()

    xs = [jnp.asarray(ops[n].reshape((-1,) + ops[n].shape[2:])) for n in ("op", "lp", "oa", "la")]
    out, lse = jax.jit(lambda *a: red(*a, *arrays))(*xs)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*xs)
    res = {"out": out, "lse": lse}
    res.update({f"d{n}": g for n, g in zip(("op", "lp", "oa", "la"), grads)})
    return {n: np.asarray(x).reshape((cp, -1) + np.asarray(x).shape[1:]) for n, x in res.items()}


@pytest.mark.parametrize("impl", ["a2a", "hops"])
@pytest.mark.parametrize("cp", [2, 4])
def test_group_reduce_lse_matches_jax(cp, impl, pools):
    send_map, ops = _reduce_operands(cp)
    got = pools[cp].run(workers.reduce_lse, impl, ops, send_map, ROWS)
    ref = _jax_reduce(send_map, ops, cp, impl)
    for r, res in enumerate(got):
        assert res["impl"] == impl
        assert np.isneginf(res["lse"][12:14]).all() and not res["out"][12:14].any()
        for name in ("out", "lse", "dop", "dlp", "doa", "dla"):
            assert np.isfinite(res[name]).all() or name == "lse", (r, name)
            np.testing.assert_allclose(res[name], ref[name][r], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("impl", ["a2a", "hops"])
def test_planted_reduce_fault_is_caught(impl, pools):
    cp = 2
    send_map, ops = _reduce_operands(cp)
    got = pools[cp].run(workers.reduce_lse, impl, {**ops, "drop_remote": True}, send_map, ROWS)
    ref = _jax_reduce(send_map, ops, cp, impl)
    for name in ("out", "lse"):
        assert not all(np.allclose(res[name], ref[name][r], rtol=1e-5, atol=1e-6)
                       for r, res in enumerate(got)), name
