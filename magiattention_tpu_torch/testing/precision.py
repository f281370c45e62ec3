"""Precision harness: tolerance checks relative to a reference.

The counterpart of the JAX package's ``testing/precision.py``: a
low-precision implementation is close enough when its error against a
high-precision oracle is within a ratio of the error that a low-precision
reference implementation makes against the same oracle, plus infinity-norm
checks. Takes tensors or numpy arrays; computes in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

# the implementation under test may make up to this many times the error of
# the low-precision reference before it fails
MISMATCH_THRES_RATIO = 2.0
EPS = 1e-8

_ATOL = {"bfloat16": 2e-2, "float32": 1e-5}
_RTOL = {"bfloat16": 2e-2, "float32": 1e-5}


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def calc_inf_norm(x, ref) -> float:
    """Infinity norm of (x - ref), in float64."""
    xa, ra = _f64(x), _f64(ref)
    return float(np.max(np.abs(xa - ra))) if xa.size else 0.0


def calc_rel_err(x, ref) -> float:
    """Relative L2 error of x against ref, in float64."""
    xa, ra = _f64(x).ravel(), _f64(ref).ravel()
    return float(np.linalg.norm(xa - ra) / (np.linalg.norm(ra) + EPS))


def assert_close(actual, expected, *, atol: float | None = None, rtol: float | None = None,
                 msg: str = "") -> None:
    """Elementwise closeness with per-dtype defaults (the dtype of
    ``actual``: bf16 2e-2 / 2e-2, float32 1e-5 / 1e-5, else 1e-8 / 1e-7)."""
    dtype = str(actual.dtype if hasattr(actual, "dtype") else np.asarray(actual).dtype)
    dtype = dtype.removeprefix("torch.")
    if atol is None:
        atol = _ATOL.get(dtype, 1e-8)
    if rtol is None:
        rtol = _RTOL.get(dtype, 1e-7)
    np.testing.assert_allclose(_f64(actual), _f64(expected), atol=atol, rtol=rtol, err_msg=msg)


def assert_close_to_ref(actual, ref_lp, ref_hp, *,
                        mismatch_thres_ratio: float = MISMATCH_THRES_RATIO,
                        norm_atol: float = 1e-2, msg: str = "") -> None:
    """Relative-to-reference check: ``actual`` (the implementation under
    test) against ``ref_hp`` (the oracle at high precision), allowed
    ``mismatch_thres_ratio`` times the error of ``ref_lp`` (the reference
    at the same precision as ``actual``)."""
    err_actual = calc_rel_err(actual, ref_hp)
    err_ref = calc_rel_err(ref_lp, ref_hp)
    thres = max(err_ref * mismatch_thres_ratio, EPS * 10)
    assert err_actual <= thres or err_actual <= 1e-6, (
        f"{msg}: rel err {err_actual:.3e} exceeds {mismatch_thres_ratio}x "
        f"reference err {err_ref:.3e}"
    )
    inf_norm = calc_inf_norm(actual, ref_hp)
    ref_inf_norm = calc_inf_norm(ref_lp, ref_hp)
    assert inf_norm <= max(ref_inf_norm * mismatch_thres_ratio, norm_atol), (
        f"{msg}: inf-norm {inf_norm:.3e} exceeds "
        f"{mismatch_thres_ratio}x reference inf-norm {ref_inf_norm:.3e}"
    )
