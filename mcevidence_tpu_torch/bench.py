"""Benchmark of the port: evidence wall time on the card against the CPU.

The counterpart of the repository's ``bench.py``.  Run as

    python -m mcevidence_tpu_torch.bench [--device cuda|cpu]

Workload: bench.py's, auto evidence on its synthetic chain (N=65536, d=8,
kmax=5; the size class of the largest Planck full-grid chains).  The timed
step is ``ops/pipeline.py:fused_auto_evidence`` under the
``pallas_packed2`` engine: whitening from f64 moments on the device, the
selection of TPU kernel K1's counterpart (``knn_select_packed`` at 12 low
bits) and the f32 estimator, k_start = 1, log prior volume 0.  REPS runs,
each on ``samples + 1e-6*i``, are enqueued back to back with no host sync
in the loop; a CUDA event before the first and one after the last give the
device wall, then one synchronize and one scalar fetch.  The best of the
timed attempts is kept.  On ``--device cpu`` the same call runs the plain
PyTorch selection (``timed_kernel: "plain"``), for bounded runs of the
whole path; ``MCE_BENCH_N``, ``MCE_BENCH_REPS`` and
``MCE_BENCH_TIMED_ATTEMPTS`` shrink it.

Baseline: the reference's estimator in f64 numpy on this host's CPU, its
kNN by sklearn's ``NearestNeighbors(n_jobs=-1)`` where sklearn imports,
else by ``scipy.spatial.cKDTree.query(workers=-1)`` (the same exact f64
kNN); ``baseline_impl`` names the one that ran.  Its ln Z is the oracle of
the three parity fields.

Prints ONE JSON line last, bench.py's schema: ``value`` = N^2 pairs per
second of the device wall, ``vs_baseline`` = baseline wall / device wall,
``device_wall_s`` (bench.py's ``tpu_wall_s``), ``sklearn_cpu_wall_s`` (the
baseline's wall, whichever ran), the parity fields, plus
``evidence_fn_wall_s`` (median of 3 warm ``evidence_fn`` calls in each
precision), ``refine_split_s`` (refine's ``knn_s``, the fastest of 7
``exact_knn`` calls, and that call's parts: the first-pass selection, the
f64 refine on the card and its fetch, the guard's reselection and the
rest) and ``launches``
(the kernel wrappers' launch counts over the run, and ``plain_on_cuda``,
the CUDA tensors that reached the plain selection).
On any exception, or when a phase outlives its deadline, the last line is a
failure line (value 0, ``error``, ``phase``) and the exit code is not 0.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import threading
import time
from argparse import ArgumentParser

import numpy as np
import torch

METRIC = "nn_pairs_per_sec_per_chip"
NDIM, KMAX = 8, 5
TIMED_ENGINE = "pallas_packed2"
# timed exact_knn calls behind refine_split_s
SPLIT_RUNS = 7


def _failure_line(error: str, phase: str = "") -> str:
    """ONE schema-compatible JSON line marking a failed run (value 0);
    ``phase`` names the stage that failed or blocked."""
    rec = {"metric": METRIC, "value": 0.0, "unit": "pairs/s",
           "vs_baseline": 0.0, "error": error}
    if phase:
        rec["phase"] = phase
    return json.dumps(rec)


class _Watchdog:
    """Phase-scoped deadline: pet() at each stage boundary re-arms the timer
    with that stage's own budget, so a slow-but-alive stage (a first kernel
    build) is not killed by an unrelated stage's deadline, while a blocked
    stage still emits the failure line naming the stage it blocked in."""

    def __init__(self):
        self._timer = None
        self.phase = "start"

    current_phase = "start"            # class-level: read by __main__'s
                                       # except handler for the failure line

    def pet(self, phase: str, seconds: float) -> None:
        self.cancel()
        self.phase = phase
        _Watchdog.current_phase = phase

        def fire():
            print(_failure_line(
                f"no progress within {seconds:.0f}s during '{phase}' "
                "(device unreachable?)", phase), flush=True)
            os._exit(2)
        self._timer = threading.Timer(seconds, fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def synthetic_chain(n, ndim, seed=0):
    """bench.py's chain: drawn exactly from its own normalised Gaussian
    likelihood (mean 1..ndim, sigma 0.05)."""
    rng = np.random.default_rng(seed)
    mean = np.arange(1.0, ndim + 1.0)
    sigma = np.full(ndim, 0.05)
    theta = rng.normal(mean, sigma, size=(n, ndim))
    dm = (theta - mean) / sigma
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 0.5 * ndim * np.log(2 * np.pi) - np.sum(np.log(sigma)))
    return theta, lnl


BASELINES = ("sklearn", "scipy_ckdtree")


def baseline_impl() -> str:
    """``"sklearn"`` where scikit-learn imports, else ``"scipy_ckdtree"``."""
    try:
        import sklearn.neighbors  # noqa: F401
    except ImportError:
        return "scipy_ckdtree"
    return "sklearn"


def sklearn_reference(theta, lnl, kmax, impl=None):
    """The reference's estimator: an exact f64 kNN on the host CPU and the
    float64 numpy formula.  ``impl`` is one of ``BASELINES`` (default
    ``baseline_impl()``).  Returns ln Z for k = 1..kmax-1."""
    import scipy.special as sp
    impl = impl or baseline_impl()
    n, ndim = theta.shape
    cov = np.cov(theta.T)
    ev, evec = np.linalg.eigh(cov)
    jac = math.sqrt(np.linalg.det(cov))
    s = (theta @ evec) / np.sqrt(ev)
    if impl == "sklearn":
        from sklearn.neighbors import NearestNeighbors
        D, _ = NearestNeighbors(n_neighbors=kmax + 1,
                                n_jobs=-1).fit(s).kneighbors(s)
    elif impl == "scipy_ckdtree":
        from scipy.spatial import cKDTree
        D, _ = cKDTree(s).query(s, k=kmax + 1, workers=-1)
    else:
        raise ValueError(f"unknown baseline {impl!r}; expected one of "
                         f"{BASELINES}")
    lmax = lnl.max()
    fs = np.exp(lnl - lmax)
    out = []
    for k in range(1, kmax):
        vol = math.pi ** (ndim / 2) * D[:, k] ** ndim / sp.gamma(1 + ndim / 2)
        amax = np.dot(vol, fs) / (n * k + 1.0)
        out.append(math.log(n * amax * jac) + lmax)
    return np.array(out)


def chain_tensors(theta, lnl, device):
    """bench.py's f32 inputs of the timed step on ``device``: the chain as
    drawn (not centred: the step whitens from f64 moments), its lnL and
    unit weights."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return f32(theta), f32(lnl), torch.ones(len(lnl), dtype=torch.float32,
                                            device=device)


def evidence_reps(samples, lnlike, weights, reps, engine=TIMED_ENGINE):
    """``reps`` runs of the timed step enqueued back to back on the
    tensors' device, run i on ``samples + 1e-6*i``, with no host sync here.
    Returns (the runs' k=1 ln Z summed, as a 0-dim tensor; the first run's
    (kmax,) MLE row, column 0 unused)."""
    from .ops.pipeline import fused_auto_evidence
    lpv = samples.new_zeros(())
    total, first = samples.new_zeros(()), None
    for i in range(reps):
        mle = fused_auto_evidence(samples + 1e-6 * i, lnlike, weights, lpv,
                                  kmax=KMAX, engine=engine)
        total = total + mle[1]
        first = mle if first is None else first
    return total, first


class _Clock:
    """Device time of enqueued work: CUDA events on a card, the host clock
    (the work is synchronous) on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, start):
        """Seconds since ``start``; on a card, once the stream has passed
        an event recorded now (the caller's synchronize or fetch)."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return time.perf_counter() - start


def refine_split(white, kmax, device):
    """One refine-precision ``ops/knn.py:exact_knn(white, None, kmax)``
    call, timed in parts by the program's own spans (``utils/spans.py``).
    Returns (its distances, the split): ``kernel``, the first pass's
    ``select`` span, the host's wait for the launch and for the selection
    to finish (no index copy: the indices stay on the card);
    ``host_refine``, the first pass's f64 refine and margin test on the
    card and the fetch of the k distances; ``reselect``, the guard's
    reselection if it fired (its selection and refine); ``rest``, the
    call's wall less those (the host centring, the upload);
    ``knn_s``, the call's wall."""
    from .ops.knn import exact_knn
    from .utils.spans import collect, span
    timings, spans = {}, []
    with collect(timings, spans), span("knn"):
        d = exact_knn(white, None, kmax, device=device)
    again = [(a, b) for name, _, a, b in spans if name == "reselect"]

    def first_pass(name):
        return sum(b - a for n, _, a, b in spans if n == name and not any(
            ra <= a and b <= rb for ra, rb in again))
    parts = {"kernel": first_pass("select"),
             "host_refine": first_pass("host_refine"),
             "reselect": timings.get("reselect_s", 0.0)}
    parts["rest"] = timings["knn_s"] - sum(parts.values())
    parts["knn_s"] = timings["knn_s"]
    return d, parts


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.bench",
                       description="evidence wall time of the port on the "
                                   "card against the CPU baseline; one JSON "
                                   "line")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu' "
                        "(the plain PyTorch selection)")
    args = p.parse_args(argv)
    watchdog = _Watchdog()
    watchdog.pet("device-init", 300.0)
    from .evidence import evidence_fn
    from .ops import knn_hopper as kh
    from .ops.pipeline import device_refine_auto_evidence, fast_auto_evidence
    from .ops.whiten import apply_whiten, whiten_stats
    from .utils.device import gpu_name_and_power_limit, resolve_device
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    clock = _Clock(dev)
    kh.reset_launch_counts()

    # canonical workload; the overrides exist for bounded CPU runs
    N = int(os.environ.get("MCE_BENCH_N", "65536"))
    REPS = int(os.environ.get("MCE_BENCH_REPS", "8"))
    attempts = int(os.environ.get("MCE_BENCH_TIMED_ATTEMPTS", "3"))
    theta, lnl = synthetic_chain(N, NDIM)
    s32, l32, w32 = chain_tensors(theta, lnl, dev)

    # first call: builds and loads the kernel's library on a card
    watchdog.pet("warmup-build", 1200.0)
    _, mle = evidence_reps(s32, l32, w32, REPS)
    mle = mle.cpu().numpy().astype(np.float64)

    walls = []
    for _ in range(attempts):
        watchdog.pet("timed-run", 300.0)
        start = clock.start()
        total, _ = evidence_reps(s32, l32, w32, REPS)
        wall = clock.seconds(start)
        float(total)                   # the one scalar fetch
        walls.append(wall / REPS)
    device_s = min(walls)

    watchdog.pet("baseline", 900.0)
    impl = baseline_impl()
    t0 = time.perf_counter()
    oracle = sklearn_reference(theta, lnl, KMAX, impl)
    cpu_s = time.perf_counter() - t0
    dlnz = float(np.max(np.abs(mle[1:] - oracle)))

    # parity of the device precision (f64 refinement on the card, scalars
    # back), timed warm, and of the fast precision (the exact kernel)
    watchdog.pet("device-mode-parity", 900.0)
    device_refine_auto_evidence(theta, lnl, kmax=KMAX, device=dev)
    t0 = time.perf_counter()
    dev_lnz = device_refine_auto_evidence(theta, lnl, kmax=KMAX, device=dev)
    dev_wall = time.perf_counter() - t0
    dlnz_dev = float(np.max(np.abs(dev_lnz - oracle)))
    fast = fast_auto_evidence(theta, lnl, kmax=KMAX, device=dev)
    dlnz_fast = float(np.max(np.abs(np.asarray(fast) - oracle)))

    watchdog.pet("evidence-fn", 900.0)
    fn_walls = {}
    for precision in ("refine", "device", "fast"):
        evidence_fn(theta, lnl, kmax=KMAX, precision=precision, device=dev)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            evidence_fn(theta, lnl, kmax=KMAX, precision=precision,
                        device=dev)
            runs.append(time.perf_counter() - t0)
        fn_walls[precision] = statistics.median(runs)

    # refine's knn_s (exact_knn's wall, as MCEvidence times it) in parts,
    # the split of the fastest of SPLIT_RUNS calls (a loaded host only
    # ever slows a call down)
    watchdog.pet("refine-split", 900.0)
    white = apply_whiten(theta, whiten_stats(theta))
    refine_split(white, KMAX, dev)
    refine_split_s = min((refine_split(white, KMAX, dev)[1]
                          for _ in range(SPLIT_RUNS)),
                         key=lambda split: split["knn_s"])

    watchdog.cancel()
    print(json.dumps({
        "metric": METRIC,
        "value": N * N / device_s,
        "unit": "pairs/s",
        "vs_baseline": cpu_s / device_s,
        "timed_rep_walls_s": walls,
        "device_wall_s": device_s,
        "sklearn_cpu_wall_s": cpu_s,
        "baseline_impl": impl,
        "backend": dev.type,
        "gpu": gpu_name_and_power_limit(),
        "workload": f"auto evidence N={N} d={NDIM} kmax={KMAX} reps={REPS}",
        "max_abs_dlnz_vs_f64_oracle_timed_kernel": dlnz,
        "timed_kernel": TIMED_ENGINE if on_card else "plain",
        "max_abs_dlnz_vs_f64_oracle_fast_mode": dlnz_fast,
        "max_abs_dlnz_vs_f64_oracle_device_mode": dlnz_dev,
        "device_mode_wall_s_incl_host_prep": dev_wall,
        "evidence_fn_wall_s": fn_walls,
        "refine_split_s": refine_split_s,
        "launches": {**{w.__name__: w.launches for w in kh.KERNEL_WRAPPERS},
                     "plain_on_cuda": kh.plain_cuda_calls},
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:
        # the schema line rather than a bare traceback, so the record stays
        # machine-readable; the traceback follows on stderr
        print(_failure_line(f"{type(e).__name__}: {e}",
                            _Watchdog.current_phase), flush=True)
        raise
