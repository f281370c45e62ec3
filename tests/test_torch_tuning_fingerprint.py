"""The port's tuning fingerprints (``magiattention_tpu_torch/tuning/
fingerprint.py``) against the JAX package's, on the CPU.

Every mask statistic of the flex fingerprint, ``_log2_bucket`` at its
edges, and the decode and tick buckets equal JAX's ``make_*_fingerprint``
on the same masks (made from a seed with numpy) and geometries; the
fingerprint is deterministic, absorbs token jitter, drops degenerate
slices, and keeps apart the CPU and the card, and two cards."""

import numpy as np
import pytest

from magiattention_tpu.tuning import fingerprint as jfp
from magiattention_tpu_torch.tuning import fingerprint as fp
from magiattention_tpu_torch.utils import cost

STATS = ("total_q", "total_k", "num_heads_q", "num_heads_kv", "head_dim", "dtype", "num_slices",
         "covered_frac_milli", "mean_k_width_bucket", "max_k_width_bucket",
         "mean_q_width_bucket", "causal_frac_milli", "max_block_q", "max_block_k",
         "sparse_rungs")


def _varlen(seed: int, total: int = 4096):
    """Documents of random lengths, each causal, plus random full, causal,
    inv-causal and bi-causal cross slices."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, total), size=rng.integers(2, 12), replace=False))
    bounds = [0, *cuts.tolist(), total]
    qr = [(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
    kr, ty = list(qr), [1] * len(qr)
    for _ in range(int(rng.integers(1, 5))):
        q0 = int(rng.integers(0, total - 64))
        k0 = int(rng.integers(0, total - 64))
        qr.append((q0, q0 + int(rng.integers(32, 64))))
        kr.append((k0, k0 + int(rng.integers(32, 64))))
        ty.append(int(rng.integers(0, 4)))
    return qr, kr, ty


MASKS = {
    "causal_4096": ([(0, 4096)], [(0, 4096)], [1]),
    "full_1000x3000": ([(0, 1000)], [(0, 3000)], [0]),
    "window": ([(0, 511), (511, 8192)], [(0, 511), (0, 8192)], [1, 3]),
    **{f"varlen_seed{s}": _varlen(s) for s in range(6)},
}


@pytest.mark.parametrize("include_sparse", [True, False])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_statistics_equal_jaxs(name, include_sparse):
    qr, kr, ty = MASKS[name]
    kw = dict(head_dim=128, dtype="bfloat16", max_block_q=2048, include_sparse=include_sparse)
    got = fp.make_fingerprint(qr, kr, ty, 16, 8, device="cpu", **kw)
    want = jfp.make_fingerprint(qr, kr, ty, 16, 8, **kw)
    for f in STATS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.version == want.version
    # the per-tile estimates count over the port's one tile
    (bq, bk, _), = got.entry_est
    assert (bq, bk) == (64, 64)


@pytest.mark.parametrize("x", [-3.0, 0.0, 1e-9, 0.5, 1.0, 1.04, 1.0905, 1.0906, 2.0, 3.0, 1000.0,
                               2 ** 0.0625, 2 ** 0.1875 - 1e-12, 16384.0, 65536.0 + 1])
def test_log2_bucket_edges_equal_jaxs(x):
    assert fp._log2_bucket(x) == jfp._log2_bucket(x)
    assert fp._log2_bucket(x, per_octave=4) == jfp._log2_bucket(x, per_octave=4)


@pytest.mark.parametrize("batch,mpp,groups", [(1, 1, 0), (3, 48, 0), (8, 64, 2), (17, 256, 5),
                                              (64, 7, 1)])
def test_decode_buckets_equal_jaxs(batch, mpp, groups):
    got = fp.make_decode_fingerprint(batch, mpp, 128, 32, 8, head_dim=64, dtype="float32",
                                     prefix_groups=groups, device="cpu")
    want = jfp.make_decode_fingerprint(batch, mpp, 128, 32, 8, head_dim=64, dtype="float32",
                                       prefix_groups=groups)
    for f in ("kind", "version", "batch_bucket", "num_heads_q", "num_heads_kv", "head_dim",
              "dtype", "page_size", "max_pages_bucket", "prefix_groups_bucket"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("rows,entries,prefill", [(8, 1, 0), (64, 16, 0), (512, 64, 300),
                                                  (2048, 128, 2000)])
def test_tick_buckets_equal_jaxs(rows, entries, prefill):
    got = fp.make_tick_fingerprint(rows, entries, 16, 4, 2, head_dim=32, prefill_rows=prefill,
                                   device="cpu")
    want = jfp.make_tick_fingerprint(rows, entries, 16, 4, 2, head_dim=32, prefill_rows=prefill)
    for f in ("kind", "version", "row_bucket", "entry_bucket", "num_heads_q", "num_heads_kv",
              "head_dim", "dtype", "page_size", "prefill_rows_bucket"):
        assert getattr(got, f) == getattr(want, f), f


def test_deterministic_and_dtype_spelling():
    qr, kr, ty = MASKS["varlen_seed1"]
    a = fp.make_fingerprint(qr, kr, ty, 8, 8, device="cpu")
    fp._FP_MEMO.clear()
    b = fp.make_fingerprint(np.asarray(qr), np.asarray(kr), np.asarray(ty), 8, 8, device="cpu")
    assert a == b and a is not b and a.stable_hash() == b.stable_hash()
    import torch

    assert fp.make_fingerprint(qr, kr, ty, 8, 8, dtype=torch.bfloat16, device="cpu") == a


@pytest.mark.parametrize("drift", [20, 64])
def test_token_jitter_is_absorbed(drift):
    """A few tokens of drift stay inside the log2 buckets (as JAX's
    ``test_fingerprint_absorbs_token_jitter``); a different shape re-keys."""
    def causal(t):
        return [(0, t)], [(0, t)], [1]

    a = fp.make_fingerprint(*causal(16384), 8, 8, device="cpu")
    b = fp.make_fingerprint(*causal(16384 - drift), 8, 8, device="cpu")
    assert a.stable_hash() == b.stable_hash()
    assert fp.make_fingerprint(*causal(12000), 8, 8, device="cpu").stable_hash() != a.stable_hash()


def test_degenerate_slices_are_dropped():
    qr, kr, ty = MASKS["varlen_seed2"]
    padded = (qr + [(4096, 4096), (10, 10)], kr + [(0, 0), (5, 9)], ty + [1, 0])
    assert fp.make_fingerprint(*padded, 8, 8, device="cpu") == \
        fp.make_fingerprint(qr, kr, ty, 8, 8, device="cpu")


def test_devices_and_cards_are_kept_apart(monkeypatch):
    import torch

    qr, kr, ty = MASKS["causal_4096"]
    on_cpu = fp.make_fingerprint(qr, kr, ty, 8, 8, device="cpu")
    assert (on_cpu.generation, on_cpu.backend) == ("cpu", "cuda@cpu")
    monkeypatch.setattr(cost, "current_card", lambda device=None: "NVIDIA H100 80GB HBM3")
    h100 = fp.make_fingerprint(qr, kr, ty, 8, 8, device=torch.device("cuda"))
    assert (h100.generation, h100.backend) == ("NVIDIA H100 80GB HBM3", "cuda@cuda")
    monkeypatch.setattr(cost, "current_card", lambda device=None: "NVIDIA A100-SXM4-80GB")
    a100 = fp.make_fingerprint(qr, kr, ty, 8, 8, device=torch.device("cuda"))
    hashes = {on_cpu.stable_hash(), h100.stable_hash(), a100.stable_hash()}
    assert len(hashes) == 3
    d_cpu = fp.make_decode_fingerprint(8, 64, 128, 32, 8, device="cpu")
    d_card = fp.make_decode_fingerprint(8, 64, 128, 32, 8, device=torch.device("cuda"))
    assert d_cpu.stable_hash() != d_card.stable_hash()
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "torch")
    assert fp.make_fingerprint(qr, kr, ty, 8, 8, device="cpu").backend == "torch@cpu"
