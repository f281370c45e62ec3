"""Checkpoint and resume of a trainer's state: the port's twin of the JAX
package's ``utils/checkpoint.py`` (orbax there, ``torch.save`` /
``torch.load(weights_only=True)`` here).

The state is the trainers' own, a nested dict such as ``{"model":
model.state_dict(), "optimizer": opt.state_dict()}`` (tensors, numbers,
strings, lists, tuples, dicts). Step ``n`` lives in ``path/<n>/state.pt``:
written into a temporary directory, flushed to disk and renamed, so that a
step is whole and durable when :func:`save_train_state` returns and a
crash leaves no half-written step behind. Runtime keys and plans are not
saved, as in the JAX package: they are rebuilt from the mask and the
layout.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

_STATE_FILE = "state.pt"


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(n) for n in os.listdir(path)
                  if n.isdigit() and os.path.isfile(os.path.join(path, n, _STATE_FILE)))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_train_state(path: str, step: int, state: Any, *, max_to_keep: int | None = 3) -> None:
    """Save ``state`` as step ``step`` under ``path`` (made if missing),
    durable on return; then keep only the newest ``max_to_keep`` steps
    (None keeps all). A step already saved is replaced whole."""
    import torch

    step = int(step)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(step))
    tmp = os.path.join(path, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(path)
    if max_to_keep is not None:
        for old in _steps(path)[:-max_to_keep]:
            shutil.rmtree(os.path.join(path, str(old)))


def latest_step(path: str) -> int | None:
    """The newest saved step under ``path``, or None when nothing is saved."""
    steps = _steps(path)
    return steps[-1] if steps else None


def _check_like(saved: Any, template: Any, where: str) -> Any:
    """``saved`` with each tensor on its template's device, after checking
    that it has the template's structure, shapes and dtypes."""
    import torch

    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: the template holds a tensor, the checkpoint "
                             f"{type(saved).__name__}")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"{where}: saved {tuple(saved.shape)} {saved.dtype}, template "
                             f"{tuple(template.shape)} {template.dtype}")
        return saved.to(template.device)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or not set(template) <= set(saved):
            got = sorted(map(str, saved)) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"{where}: saved keys {got} lack template keys "
                             f"{sorted(map(str, template))}")
        # entries the template lacks (a fresh optimizer has no per-parameter
        # state yet) come back as saved
        return {k: _check_like(v, template[k], f"{where}.{k}") if k in template
                else v for k, v in saved.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"{where}: saved {type(saved).__name__} of "
                             f"{len(saved) if isinstance(saved, (list, tuple)) else '-'}, "
                             f"template {type(template).__name__} of {len(template)}")
        return type(saved)(_check_like(s, t, f"{where}[{i}]")
                           for i, (s, t) in enumerate(zip(saved, template)))
    return saved


def restore_train_state(path: str, *, step: int | None = None,
                        template: Any = None) -> tuple[int, Any]:
    """``(step, state)`` from ``path``; ``step`` defaults to the newest.

    ``template``: a state of the same structure (e.g. a fresh model's and
    optimizer's ``state_dict()``); the restore checks every tensor the
    template holds for its shape and dtype, and every key it holds for
    presence, and raises ``ValueError`` naming the first that drifted, at
    load time instead of mid-training; each such tensor goes to its
    template's device. Entries the template lacks (the per-parameter state
    a fresh optimizer does not have yet) and every tensor without a
    template come back on the CPU, where ``load_state_dict`` moves them."""
    import torch

    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    file = os.path.join(path, str(int(step)), _STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint of step {step} under {path}")
    state = torch.load(file, map_location="cpu", weights_only=True)
    if template is not None:
        state = _check_like(state, template, f"checkpoint {path} step {step}")
    return int(step), state
