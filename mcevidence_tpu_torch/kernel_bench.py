"""Kernel timings: each selection kernel beside its plain version, its bound
and one library call.

The counterpart of the repository's kernel studies
(``scripts/bench_packed2.py``, ``bench_packed2_batched.py``,
``bench_smalld.py`` and ``bench_prologue.py``) on the port's kernels.  Run
as

    python -m mcevidence_tpu_torch.kernel_bench [--study NAME]
        [--kernel NAME] [--n N] [--d D] [--k K ...] [--batch B]
        [--reps R] [--no-plain] [--device cuda|cpu]

With ``--kernel`` it times one wrapper of ``ops/knn_hopper.py`` in self
mode on ``--n`` rows of width ``--d`` (``--batch`` members for the batched
forms), one row a ``--k``; with ``--study`` it runs one study's comparison:

* ``packed2``: K6's counterpart, ``knn_select_packed(low_bits=11)``, beside
  K1's, ``knn_select_small_k``, at k = 1, 5, 9 (N=32768, d=8);
* ``packed2_batched``: ``knn_select_packed`` on (B, N, d) beside
  ``knn_select_batched`` at (B, N) = (4, 8192) and (4, 32768), k=6, d=8,
  N - 37 valid rows a member;
* ``smalld``: ``knn_select_smalld`` beside the small-k and large-k bodies
  (``knn_select_small_k`` below k=14, ``knn_select_large_k`` from there),
  at k = 1, 5, 9 (N=32768, d=8);
* ``prologue``: ``knn_select_prologue`` B and BC beside
  ``knn_select_small_k`` and K1's function without the cuts
  (``knn_select_packed(low_bits=12)``) at k = 5, 1 (N=65536, d=8), after a
  gate: B and BC must return K1's function's bits at N=4096, k=5.

Each row is one JSON line: ``ms`` (CUDA events, median of ``--reps``
after one warm-up call), ``plain_ms`` (the plain PyTorch version on the
same inputs), ``bound_ms`` and ``bound_by`` (``bound``: the least time the
card could take for the TPU kernel's f32 work, so it reads the same work
whatever implements it), ``share_of_bound``, ``library_ms`` (the pair
``torch.cdist`` then ``torch.topk`` on the same inputs: no single PyTorch
call selects k nearest neighbours) and ``gpu``, the card's name and power
limit.  TF32 is switched off.  On ``--device cpu`` the wrappers take their
plain version and the clock is the host's.
"""

from __future__ import annotations

import functools
import json
import statistics
import sys
import time
from argparse import ArgumentParser
from typing import Callable

import numpy as np
import torch

FP32_PEAK = 67e12             # H100 SXM f32 outside the tensor cores, 700 W
HBM_RATE = 3.35e12            # H100 SXM HBM3 bytes/s
KERNELS = ("knn_select_small_k", "knn_select_large_k", "knn_select_batched",
           "knn_select_smalld", "knn_select_packed", "knn_select_prologue",
           "knn_select_wide")
# the library pair's query chunks keep their distance block under this
# many bytes
LIBRARY_PAIR_BYTES = 2e9
LIBRARY_PAIR = ("torch.cdist then torch.topk(largest=False), query chunks "
                "under 2 GB of distances, TF32 off")
STUDIES = ("packed2", "packed2_batched", "smalld", "prologue")


def flops(kernel, nq, nr, d):
    """f32 operations the TPU kernel a wrapper replaces needs for nq x nr
    pairs of width d: K1-K5 take d2 by the matrix identity, 2*d flops a
    pair for the dot product and 2*d a row for the norms; K8/K9 sum
    per-coordinate differences, 3*d flops a pair (subtract, fused
    multiply-add)."""
    if kernel == "knn_select_smalld":
        return 3.0 * d * nq * nr
    return 2.0 * d * (nq * nr + nq + nr)


FLOPS_TEXT = {"knn_select_small_k": "2*d a pair + 2*d a row (K1, K4)",
              "knn_select_large_k": "2*d a pair + 2*d a row (K2, K3, K4)",
              "knn_select_batched": "2*d a pair + 2*d a row (K5)",
              "knn_select_smalld": "3*d a pair (K8, K9)",
              "knn_select_packed": "2*d a pair + 2*d a row (K6, K7, K1)",
              "knn_select_prologue": "2*d a pair + 2*d a row (S1)",
              "knn_select_wide": "2*d a pair + 2*d a row (K2, K4, K6 past "
                                 "k = 256 or d = 64)"}


def bound(kernel, n, d, k, batch=1):
    """The least time the card could take for one self selection of ``n``
    rows of width d per member: the larger of the operations (``flops``)
    over the FP32 peak and the bytes (the rows read once, the d2 and
    indices written once) over the memory rate.  Returns (ms, what binds
    it)."""
    ops = batch * flops(kernel, n, n, d) / FP32_PEAK
    nbytes = batch * (4.0 * n * d + 8.0 * n * k) / HBM_RATE
    return max(ops, nbytes) * 1e3, ("operations" if ops >= nbytes
                                    else "bytes")


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` on the host's clock, after one
    warm-up (the CPU, where no CUDA event exists)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def timer_for(device) -> Callable:
    return cuda_ms if torch.device(device).type == "cuda" else host_ms


def library_pair(q, k):
    """The library yardstick of a self selection: ``torch.cdist`` then
    ``torch.topk(largest=False)`` over chunks of query rows whose distance
    block stays under ``LIBRARY_PAIR_BYTES``; q is (N, d) or (B, N, d).
    Returns each chunk's (distances, indices)."""
    batch = q.shape[0] if q.dim() == 3 else 1
    n = q.shape[-2]
    rows = max(1, int(LIBRARY_PAIR_BYTES // (batch * n * 4)))
    return [torch.topk(torch.cdist(q[..., lo:lo + rows, :], q), k, dim=-1,
                       largest=False) for lo in range(0, n, rows)]


def time_row(kernel, shape, run, n, d, k, *, plain=None, library=None,
             batch=1, reps=5, timer=cuda_ms, gpu=None, **extra):
    """One timing row of ``kernel`` on a self selection of ``n`` rows of
    width d per member (``batch`` members): ``run``, ``plain`` and
    ``library`` are calls without arguments (``plain``/``library`` None:
    not measured, null in the row).  Prints the row as one JSON line
    ``{"phase": "time", ...}`` and returns it."""
    ms = timer(run, reps)
    plain_ms = timer(plain, reps) if plain is not None else None
    library_ms = timer(library, reps) if library is not None else None
    b_ms, b_by = bound(kernel, n, d, k, batch)
    pairs = float(batch) * n * n
    row = {"kernel": kernel, "shape": shape, **extra, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by, "share_of_bound": b_ms / ms,
           "pairs_per_s": pairs / (ms * 1e-3)}
    if plain_ms is not None:
        row["plain_pairs_per_s"] = pairs / (plain_ms * 1e-3)
    row["gpu"] = gpu
    print(json.dumps({"phase": "time", **row}), flush=True)
    return row


def self_row(kernel, fn, x, k, shape, *, plain=None, library=True, nr=None,
             with_plain=True, **kw):
    """``time_row`` of ``fn(x, x, k, self_mode=True)`` on (N, d) or
    (B, N, d) rows (``nr``: each member's valid rows, the batched forms),
    with ``plain`` (a selection of the same signature; timed when
    ``with_plain``) and the library pair when ``library``."""
    counts = {} if nr is None else {"nr": nr, "nq": nr}
    plain = plain if with_plain else None
    batch = x.shape[0] if x.dim() == 3 else 1
    return time_row(
        kernel, shape, lambda: fn(x, x, k, self_mode=True, **counts),
        x.shape[-2], x.shape[-1], k,
        plain=None if plain is None else (
            lambda: plain(x, x, k, self_mode=True, **counts)),
        library=(lambda: library_pair(x, k)) if library else None,
        batch=batch, **kw)


def _exact(kh, k):
    """The exact dispatch's wrapper name and function at k."""
    name = "knn_select_small_k" if k < kh.LARGE_K_FROM else \
        "knn_select_large_k"
    return name, getattr(kh, name)


def packed2_study(x, ks=(1, 5, 9), low_bits=(11,), **kw):
    """K6's counterpart (``knn_select_packed``, 11 low bits; 12 is K1's
    function as a forced engine) beside the exact kernel the default
    dispatch runs at each k, on (N, d) rows ``x``."""
    from .ops import knn_hopper as kh
    n, d = x.shape
    rows = []
    for k in ks:
        for lb in low_bits:
            tpu = "K6" if lb == 11 else "K1 forced"
            rows.append(self_row(
                "knn_select_packed",
                functools.partial(kh.knn_select_packed, low_bits=lb), x, k,
                f"self N={n} d={d} k={k} low_bits={lb} ({tpu})",
                plain=functools.partial(kh.knn_select_torch, low_bits=lb),
                **kw))
        name, fn = _exact(kh, k)
        rows.append(self_row(name, fn, x, k,
                             f"self N={n} d={d} k={k} (beside K6, K1)",
                             plain=kh.knn_select_torch, **kw))
    return rows


def packed2_batched_study(xb, nr, k=6, **kw):
    """K7's counterpart (``knn_select_packed`` on (B, N, d), 11 low bits)
    beside K5's (``knn_select_batched``), ``nr`` valid rows a member."""
    from .ops import knn_hopper as kh
    b, n, d = xb.shape
    shape = f"self B={b} N={n} d={d} k={k} nr={nr[0]}"
    return [
        self_row("knn_select_packed", kh.knn_select_packed, xb, k,
                 shape + " low_bits=11 (K7)", nr=nr,
                 plain=functools.partial(kh.knn_select_torch_batched,
                                         low_bits=11), **kw),
        self_row("knn_select_batched", kh.knn_select_batched, xb, k,
                 shape + " (K5)", nr=nr, plain=kh.knn_select_torch_batched,
                 **kw)]


def smalld_study(x, ks=(1, 5, 9), **kw):
    """K8's counterpart (``knn_select_smalld``: exactly d squared
    differences a pair) beside the exact dispatch's body at each k, on
    (N, d) rows ``x``."""
    from .ops import knn_hopper as kh
    n, d = x.shape
    rows = []
    for k in ks:
        rows.append(self_row("knn_select_smalld", kh.knn_select_smalld, x, k,
                             f"self N={n} d={d} k={k} (smalld)",
                             plain=kh.knn_select_torch, **kw))
        name, fn = _exact(kh, k)
        rows.append(self_row(name, fn, x, k,
                             f"self N={n} d={d} k={k} (beside smalld)",
                             plain=kh.knn_select_torch, **kw))
    return rows


def prologue_gate(x, k=5, rows=4096):
    """S1's variants must return K1's function's bits (12 low bits,
    without the cuts) on the first ``rows`` rows, as
    scripts/bench_prologue.py requires before it times them; one JSON line
    a variant.  Raises AssertionError otherwise."""
    from .ops import knn_hopper as kh
    gate = x[:rows]
    want = kh.knn_select_packed(gate, gate, k, self_mode=True, low_bits=12)
    for variant in ("B", "BC"):
        got = kh.knn_select_prologue(gate, gate, k, variant=variant)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(json.dumps({
            "phase": "prologue_gate", "variant": variant,
            "shape": f"self N={gate.shape[0]} d={gate.shape[1]} k={k}",
            "identical_to_k1": same, "ok": same}), flush=True)
        if not same:
            raise AssertionError(f"prologue {variant}: differs from K1's "
                                 "function without the cuts")


def prologue_study(x, ks=(5, 1), **kw):
    """S1's counterpart (``knn_select_prologue`` B and BC) beside the
    small-k kernel the default dispatch runs and K1's function without the
    cuts (``knn_select_packed(low_bits=12)``), on (N, d) rows ``x``; k = 5
    first: at k = 1 in self mode the plain version has only the self slot
    to fill."""
    from .ops import knn_hopper as kh
    n, d = x.shape
    plain12 = functools.partial(kh.knn_select_torch, low_bits=12)
    rows = []
    for k in ks:
        for name, fn, label, plain in [
                ("knn_select_small_k", kh.knn_select_small_k,
                 "shipped small-k", kh.knn_select_torch),
                ("knn_select_packed", functools.partial(
                    kh.knn_select_packed, low_bits=12), "K1 forced", plain12),
                ("knn_select_prologue", functools.partial(
                    kh.knn_select_prologue, variant="B"), "S1 B", plain12),
                ("knn_select_prologue", functools.partial(
                    kh.knn_select_prologue, variant="BC"), "S1 BC",
                 plain12)]:
            rows.append(self_row(name, fn, x, k,
                                 f"self N={n} d={d} k={k} ({label})",
                                 plain=plain, **kw))
    return rows


def _rows(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=dev)


def run_study(name, dev, *, n=None, d=None, ks=None, **kw):
    """One study at its script's defaults (``n``, ``d``, ``ks`` replace
    them) on standard-normal rows made from seed 0; returns its rows."""
    if name == "packed2":
        return packed2_study(_rows((n or 32768, d or 8), dev), ks or (1, 5, 9),
                             **kw)
    if name == "packed2_batched":
        rows = []
        for b, m in ((4, 8192), (4, 32768)) if n is None else ((4, n),):
            rows += packed2_batched_study(_rows((b, m, d or 8), dev),
                                          [m - 37] * b, (ks or (6,))[0], **kw)
        return rows
    if name == "smalld":
        return smalld_study(_rows((n or 32768, d or 8), dev), ks or (1, 5, 9),
                            **kw)
    if name == "prologue":
        x = _rows((n or 65536, d or 8), dev)
        prologue_gate(x)
        return prologue_study(x, ks or (5, 1), **kw)
    raise ValueError(f"unknown study {name!r}; one of {STUDIES}")


def kernel_rows(kernel, dev, n, d, ks, batch=1, **kw):
    """``kernel`` (a wrapper name of ``ops/knn_hopper.py``) timed in self
    mode on standard-normal rows made from seed 0, one row a k."""
    from .ops import knn_hopper as kh
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    batched = kernel == "knn_select_batched" or batch > 1
    x = _rows((batch, n, d) if batched else (n, d), dev)
    plain = kh.knn_select_torch_batched if batched else kh.knn_select_torch
    if kernel == "knn_select_prologue":
        plain = kh.knn_select_prologue_torch
    elif kernel == "knn_select_packed":
        plain = functools.partial(plain, low_bits=11)
    shape = (f"self B={batch} N={n} d={d}" if batched
             else f"self N={n} d={d}")
    return [self_row(kernel, getattr(kh, kernel), x, k, f"{shape} k={k}",
                     plain=plain, nr=[n] * batch if batched else None, **kw)
            for k in ks]


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.kernel_bench",
                       description="selection kernels beside their plain "
                                   "version, bound and library pair; one "
                                   "JSON line a row")
    p.add_argument("--study", choices=STUDIES, default=None)
    p.add_argument("--kernel", choices=KERNELS, default=None)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--d", type=int, default=None)
    p.add_argument("--k", type=int, nargs="+", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--no-plain", action="store_true",
                   help="leave the plain version untimed (null): at 2^20 "
                        "rows it takes minutes a call")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu' "
                        "(the plain versions, on the host's clock)")
    args = p.parse_args(argv)
    if (args.study is None) == (args.kernel is None):
        p.error("give one of --study and --kernel")
    from .utils.device import gpu_name_and_power_limit, resolve_device
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(reps=args.reps, timer=timer_for(dev),
              gpu=gpu_name_and_power_limit() if dev.type == "cuda" else None,
              with_plain=not args.no_plain)
    rows = (run_study(args.study, dev, n=args.n, d=args.d, ks=args.k, **kw)
            if args.study else
            kernel_rows(args.kernel, dev, args.n or 65536, args.d or 8,
                        args.k or (9,), batch=args.batch, **kw))
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
