"""Run a function in N ``torch.distributed`` ranks on one host: the
counterpart of the reference's ``testing/dist_common.py``.

:class:`RankPool` spawns ``world`` processes once (``spawn`` start method,
file rendezvous in a fresh temporary directory, so no port is guessed),
each joins one process group (gloo by default) and then runs the tasks it
is given, ``fn(group, *args)``, returning ``fn``'s result (numpy arrays
and plain Python values) to the parent in rank order. Every multi-rank
test and the smoke's context-parallel phases use it; on one card the ranks
share ``cuda:0`` over gloo.

``fn`` must be importable by reference (a module-level function) from a
module that does not import JAX: the ranks import none of it, and
``XLA_FLAGS`` is kept out of their environment. Neither do the ranks take
the parent's ``MAGI_ATTENTION_*`` flags: a rank's environment is fixed when
it starts, so a flag the parent happened to hold then would hold in every
task the pool runs. A task that needs a flag sets it itself (and restores
it, as the ranks outlive the task), and flags every task should see are
passed as ``RankPool(..., env={name: value})``. Any rank's failure, death
or timeout raises in the parent and ends every rank.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, init_method, backend, timeout_s, threads, tasks, results):
    torch.set_num_threads(threads)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(dist.group.WORLD, *args)))
            except BaseException:  # report it to the parent, which ends every rank
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` ranks kept alive across tasks (one torch import and one
    rendezvous per pool): ``pool.run(fn, *args)`` runs ``fn(group, *args)``
    in every rank and returns the results in rank order."""

    def __init__(self, world: int, *, backend: str = "gloo", timeout_s: float = 300.0,
                 threads: int = 2, env: dict | None = None):
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="magi_ranks_")
        init_method = "file://" + os.path.join(self._dir, "rendezvous")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        # the ranks import no JAX, and start with no MAGI_ATTENTION_* flag but
        # those of ``env``: the parent's environment is put back after the spawn
        held = {n: os.environ.pop(n) for n in list(os.environ)
                if n == "XLA_FLAGS" or n.startswith("MAGI_ATTENTION_")}
        os.environ.update(env or {})
        try:
            self._procs = [
                ctx.Process(
                    target=_rank_main,
                    args=(r, self.world, init_method, backend, self.timeout_s, threads,
                          self._tasks[r], self._results),
                    daemon=True,
                )
                for r in range(self.world)
            ]
            for p in self._procs:
                p.start()
        finally:
            for n in env or {}:
                os.environ.pop(n, None)
            os.environ.update(held)

    def run(self, fn, *args, timeout_s: float | None = None) -> list:
        """``fn(group, *args)`` in every rank; the results in rank order.
        Raises (and ends the pool) when a rank fails, dies or outlives
        ``timeout_s`` (default: the pool's)."""
        for q in self._tasks:
            q.put((fn, args))
        out: list = [None] * self.world
        pending = set(range(self.world))
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        while pending:
            try:
                rank, ok, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(self._procs) if not p.is_alive()}
                if dead or time.monotonic() > deadline:
                    self.close()
                    what = f"ranks died (exit codes {dead})" if dead else "timed out"
                    raise RuntimeError(f"{getattr(fn, '__name__', fn)}: {what}")
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"rank {rank} failed in {getattr(fn, '__name__', fn)}:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
        return out

    def close(self) -> None:
        """Stop every rank (asked first, then terminated) and remove the
        rendezvous directory."""
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_ranks(fn, world: int, *args, **pool_kwargs) -> list:
    """One task in a fresh :class:`RankPool`: ``fn(group, *args)`` in
    ``world`` ranks, the results in rank order."""
    with RankPool(world, **pool_kwargs) as pool:
        return pool.run(fn, *args)
