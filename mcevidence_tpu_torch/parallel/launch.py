"""Start the ranks of a ring on one host, each a process of its own.

``RankPool(n)`` starts n processes (the ``spawn`` start method, so no
process inherits a CUDA context), joins them in one ``torch.distributed``
group through a file rendezvous in a fresh temporary directory (no port is
fixed, so runs side by side never meet), and keeps them alive:
``pool.run(fn, *args, **kwargs)`` runs ``fn`` on every rank and returns the
ranks' results in rank order.  Each rank runs with one CPU thread.  A rank
that raises fails the call with its traceback; ranks that do not answer
within ``timeout`` seconds are killed and the call raises.  Nothing is
retried.

The functions given to ``run`` are pickled by reference, so they must be
importable module-level functions; the ranks import their modules and
nothing else of the caller's.  The ``spawn`` start method also imports the
caller's main script in every rank, so a script that starts ranks keeps
its work under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, devices=None) -> None:
    """Raise unless ``backend`` can carry a ring whose ranks run on
    ``devices`` (one ``torch.device`` or name a rank, or None for the
    host): NCCL moves card tensors between ranks that each hold a card of
    their own, so two ranks on one card (or a rank on the host) need gloo,
    which moves host copies of the shards."""
    import torch
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    devs = [torch.device(d) for d in (devices or ["cpu"])]
    if any(d.type != "cuda" for d in devs):
        raise ValueError("NCCL moves card tensors; ranks on the host take "
                         "backend='gloo'")
    idx = [d.index or 0 for d in devs]
    if len(set(idx)) < len(idx):
        raise ValueError(
            f"NCCL takes one card a rank, but {len(idx)} ranks share "
            f"{len(set(idx))} card(s) (cuda:{sorted(set(idx))}); use "
            "backend='gloo', which moves host copies of the shards")


def _init_rank(rank, world, init_file, backend, timeout):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


def _serve(rank, world, init_file, backend, timeout, tasks, results):
    import torch.distributed as dist
    try:
        _init_rank(rank, world, init_file, backend, timeout)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _collect(results, procs, timeout: float, what: str) -> list:
    """The n results of one call, in rank order; raises on a failed rank,
    on a rank that died, or past ``timeout`` seconds."""
    n = len(procs)
    got = {}
    deadline = time.monotonic() + timeout
    while len(got) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"{what}: ranks {sorted(set(range(n)) - set(got))} "
                               f"gave no answer within {timeout:.0f} s")
        try:
            rank, ok, value = results.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            dead = [i for i, p in enumerate(procs)
                    if i not in got and p.exitcode is not None]
            if dead:
                raise RuntimeError(f"{what}: rank(s) {dead} exited "
                                   f"(exit codes "
                                   f"{[procs[i].exitcode for i in dead]})")
            continue
        if not ok:
            raise RuntimeError(f"{what}: rank {rank} failed:\n{value}")
        got[rank] = value
    return [got[i] for i in range(n)]


def _stop(procs, grace: float = 10.0) -> None:
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5.0)


class RankPool:
    """n ranks of one process group kept alive between calls: ``run(fn,
    *args, **kwargs)`` runs ``fn`` on every rank and returns the results
    in rank order.  A failed call closes the pool (its ranks may be stuck
    in a collective) and raises."""

    def __init__(self, n: int, *, backend: str = "gloo",
                 timeout: float = 600.0):
        self.n, self.timeout = n, timeout
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="mce_pool_")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_serve, daemon=True,
                                   args=(r, n, os.path.join(self._tmp,
                                                            "rendezvous"),
                                         backend, timeout, self._tasks[r],
                                         self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self.closed = False

    def run(self, fn, *args, **kwargs) -> list:
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        for t in self._tasks:
            t.put((fn, args, kwargs))
        try:
            return _collect(self._results, self._procs, self.timeout,
                            f"{getattr(fn, '__name__', fn)} on {self.n} "
                            "ranks")
        except BaseException:
            self.close(kill=True)
            raise

    def close(self, kill: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        if not kill:
            for t in self._tasks:
                t.put(None)
        _stop(self._procs, 0.0 if kill else 10.0)
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)
        return False
