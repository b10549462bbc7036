"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
non-zero.  Without a CUDA device, or without the package beside it, it
fails before printing any result.

1. probe: torch/CUDA versions, the card, nvcc; TF32 switched off.
2. build: nvcc builds each ``mcevidence_tpu_torch/csrc/*.cu`` for sm_90a
   into a library of its own: ``knn_select.cu`` alone first (the default
   path's first-call build), then the others, one process per source, all
   started together; no library is loaded yet.  Each source's compile
   time, and the registers and spill bytes of each body on each layout
   (the wide bodies: route A per Padded width, keys a lane and warps a
   block; route B per key and list placement) from nvcc's
   ``--resource-usage`` log.
3. kernel vs plain (the legs of ``mcevidence_tpu_torch.kernel_cert``:
   ``compare``, ``compare_batched`` and ``tie_order_broken``, one JSON line
   a leg): each kernel against its plain version on the same CUDA
   tensors: ``knn_select_small_k`` and ``knn_select_large_k`` against
   ``knn_select_torch``, ``knn_select_batched`` against
   ``knn_select_torch_batched`` member by member (heterogeneous per-member
   counts, garbage rows past them, duplicates, members with fewer rows than
   k, d = 6..16, k = 6..106), and ``knn_select_smalld`` in both forms
   (d = 1, 3, 6, 7, 8, 16; k = 1..106).  Criterion (scripts/
   tpu_kernel_cert.py:40-68): the d2 recomputed in f64 from the raw rows at
   the kernel's indices, sorted, within 2^-10 relative of the plain
   version's sorted d2, where d2 below the floor set by the f32 centring's
   rounding (from an f64 mean taken here, apart from the port's) are held
   to that floor; absent slots and the self pin equal; nothing selected at
   or past a member's count.  The ``fast`` precision consumes the exact dispatch's
   returned d2 directly, so its legs also hold the returned f32 d2 to the
   plain version's within ``D2_REL_TOL`` (2^-18: the same f32 squared
   differences of the same centred inputs, summed in another order).
   ``knn_select_packed`` at 11 and 12 low bits, 2-D and batched (self,
   cross, garbage past a count, duplicates, k > nr, d = 6..32, k = 1..106,
   heterogeneous members), and ``knn_select_prologue`` B and BC (self,
   k = 1, 5, 13, N not a multiple of 128) are held to the plain version
   with the same truncation: the same criterion, the returned d2 within one
   quantum (``PACKED_D2_REL_TOL``, 2^-11: the sums are rounded
   differently, so a d2 near a quantum's edge may fall on its other side),
   and the truncated bits of every returned d2 zero.  The selection
   bodies' edges (``csrc/knn_common.cuh``): the warp queue's boundaries
   (k = 31..33, 63..65, 128, 129, 255, 256), every row one point (all d2
   = 0, so the indices must follow the tie order exactly), nr not a
   multiple of a tile and under one tile, and blocks that mix real and
   padded query rows, each in self and cross mode on the ``Padded``,
   ``Compact`` and batched forms, under the same criterion.
   ``knn_select_wide`` (k > 256 or d > 64): self and cross, 2-D and
   batched, k = 257 / 264 / 300 / 512 / 1024 / 9000 (the lists in a global
   workspace) at d = 8 and d = 65 / 100 / 128 at k = 9 / 44, nr under one
   of its tiles and not a multiple of one,
   garbage past nr, one-point rows in the exact tie order, exact and at 11
   and 12 low bits, under the same criterion; the warp queue's edges (k =
   257, 511, 512, 513, 1023, 1024, 1025 at d = 3, 8, 32, 64, self and
   cross, batched with heterogeneous nr and nq; at d = 8 and 64 also at 11
   and 12 low bits, route B); route A ``torch.equal`` to route B where both
   apply; and at k = 9 / 44 / 200 / 256 ``torch.equal`` to the two bodies'
   bits.
4. the main paths through the user's entry points, each with the launch
   counts set to 0 just before it and read just after:
   a. refine precision: ``evidence_fn`` auto, cross, a lattice whose ties
      force the refine guard's retry, and the CLI, against an f64 oracle
      (whitening and the estimator written out here, fed by an f64
      brute-force kNN on the card) at |dlnZ| <= 1e-6; both unbatched
      kernels must launch; then a fresh process runs ``evidence_fn`` at its
      defaults, and only ``knn_select.cu``'s library may be loaded after it;
   b. device precision: ``evidence_fn(precision="device")`` auto, cross and
      the lattice retry against the same oracle at 1e-6; both must launch;
   c. the Planck grid driver at its defaults on a synthetic Planck-shaped
      grid written here, in AllChains mode (the small-k kernel must launch)
      and with ``-nc 4`` (the batched kernel must launch), each table held
      to the driver's ``--no-batch-cells --precision refine`` table at 1e-6;
   d. fast precision: ``evidence_fn`` auto, cross and kmax=20, the fused
      ``MCEvidence`` path, the CLI, and one leg with TF32 switched on
      (unchanged), against the oracle at |dlnZ| <= 3e-3
      (tests/test_evidence.py:169-176); the grid with ``--precision fast``
      in AllChains and ``-nc 4`` against the per-cell refine tables at
      5e-3 (tests/test_planck.py:161-169); the small-k, large-k and
      batched kernels must launch;
   e. the ``pallas_smalld`` engine: refine auto, cross and the lattice
      retry, and device auto, against the oracle at 1e-6; the grid with
      ``-nc 4 --engine pallas_smalld`` against the per-cell refine tables
      at 1e-6; ``knn_select_smalld`` must launch.
   f. the forced engines ``pallas_packed``, ``pallas_packed2`` and
      ``pallas_binned``: ``evidence_fn`` refine, device and fast (and the
      fused ``MCEvidence`` fast), each leg with the wrapper the engine map
      names (``ops/knn.py:selector``), against the oracle at 1e-6 (fast
      3e-3); the lattice retry under ``pallas_packed``; the grid with
      ``-nc 4`` (K7's counterpart) and AllChains (K6's) under
      ``--engine pallas_packed`` against the per-cell refine tables at
      1e-6.
   g. the JSON-lines service: ``python -m mcevidence_tpu_torch.serve
      --warmup 65536,8 --workers 2`` in a child process, and ``serve()``
      in this one, answer refine, device, fast and ``pallas_packed``
      requests and a bad one, in order, within 1e-6 (fast 3e-3) of
      ``MCEvidence`` on the same root; the CLI's ``--json`` prints the
      service's fields; ``python -m mcevidence_tpu_torch.compare`` on two
      roots gives ``MCEvidence``'s ln E.
   h. past the two bodies' limits: ``evidence_fn`` refine at kmax = 60
      (the guard's retry selects 264), fast at kmax = 300, and a
      65-parameter chain in refine, device and fast, against the oracle at
      1e-6 (fast 3e-3); ``knn_select_wide`` must launch, and no CUDA tensor
      may reach the plain selection.
5. times (the rows of ``mcevidence_tpu_torch.kernel_bench``: ``self_row``
   and its studies ``smalld_study``, ``packed2_study`` and
   ``prologue_study``): each kernel against its plain version at the main
   paths' shapes
   (the small-d kernel beside the small-k and large-k kernels at d = 3, 6,
   7, 8; the packed selections at k = 9 and 44 beside the exact ones; the
   prologue study at k = 1 and 5 beside the small-k kernel; a sweep of
   the large-k body at k = 14, 20, 26, 44, 106, 256 and the small-k body at
   k = 5, 9, 13, at N=65536 and d = 3, 8, 32), each kernel's
   bound (``bound``: the least operations of the TPU
   kernel it replaces at the card's FP32 peak, or its bytes at the memory
   rate), ``evidence_fn`` refine, device and fast wall times (also under
   ``pallas_packed``), the warm service requests' ``wall_s``, and the
   grid's per-dataset stage times, each printed with the card's name and
   power limit; the wide kernel at k = 264 / 300 (N=65536, d=8) and
   d = 65 (N=16384, k=9) beside its plain version, then its sweep with the
   route of each shape: k = 264 / 300 / 512 / 1024 / 2048 (N=65536, d=8),
   k = 300 at d = 3, 32, 64 (N=65536), d = 65 / 100 / 128 at k = 9 / 44
   (N=16384), route B's time beside route A's where both apply; and the
   library yardstick, ``library_ms``: ``torch.cdist`` then ``torch.topk``
   over query chunks under 2 GB of distances, TF32 off, on each kernel's
   first row (the kernels line quotes it) and every other row of a shape
   the port's kernel table quotes (the wide kernel's k = 264 and 300 also
   on a ``library_pair_ms`` line of its own); the sweeps have none.
6. the ring (``parallel/ring.py``): 2 and 4 ranks of one gloo group, each a
   process on the one card (NCCL takes one card a rank), with the library
   built by this process first.  ``sharded_auto_evidence`` refine and fast,
   ``sharded_cross_evidence`` and ``sharded_device_refine_evidence`` at
   N=65536, d=8, kmax=5, and on 4 ranks the 2 x 2 dp x ring grid over the
   synthetic grid's cells; every rank must give the same answer, within
   1e-9 (refine), 1e-8 (device) or 3e-3 (fast) of the one-card answer, and
   launch its kernel (the ranks' counts join the main paths' totals).
   Then ``dryrun_multichip(4)`` on the card and ``planck --distributed``
   on 2 ranks against the one-process tables.  A failed rank fails the
   phase.  The times share one card and its host: not a scaling figure.
7. the validation path (the examples and samplers), each leg with the
   launch counts set to 0 just before it and read just after:
   a. the examples' chains at scripts/validation_study.py's sizes, one
      seed a cell, through ``MCEvidence`` and ``evidence_fn`` on the card:
      ``gaussian_eg`` (d=6) and ``gaussian_corr_eg`` (d=6, 10) at N=32000,
      ``banana_eg`` at 128000, the ``glm_eg`` Gibbs chain of 4000, the
      importance-weighted chain (d=4, N=32000), the cross leg (d=8, two
      halves of 16000), ``nested_eg`` at d=2 and 4 through
      ``write_products`` and ``load_nested_chains`` (equal-weights and
      weighted), and in ``device`` precision the N sweep (d=4, N=2000 to
      128000) and the d sweep (N=32000, d=2 to 15: d=12 and 15 on the
      ``Padded<16>`` layout).  Each leg is held at 1e-6 to the same call
      with the plain selection on the card (``engine="torch"``), legs of up
      to 16000 rows a side also to the same call on ``device="cpu"``, the
      unweighted ones to the f64 oracle, and every one to its analytic or
      quadrature truth within tests/test_examples.py's band for its model
      (the sweeps within 3 rms of the bias docs/VALIDATION_STUDY.md prints,
      as ``study_document`` reads it from the document, whose chains they
      draw);
      ``knn_select_small_k`` must launch.
   b. ``glm_nuts(seed=3)`` with its gradients on the card, 2500 draws,
      under tests/test_examples.py:69-83's asserts (mean within 6 sigma of
      the ML point, ln Z estimated on the card within 0.3 of the closed
      form); the median of 200 warm gradient evaluations and the sampling
      wall time on the card and on the host.
   c. ``python -m mcevidence_tpu_torch.examples gaussian_eg 32000`` and
      ``... nested_eg`` as child processes on the card: exit 0 and print
      tests/test_examples.py:86-98's lines.
   d. ``MCEvidence(...).evidence(profile=True)`` with ``MCE_PROFILE_DIR``
      set, refine, device and fast at N=65536, d=8, kmax=5: bit-equal to
      the untraced call; each Chrome trace read back for its CUDA kernel
      time by name, its window and the device-busy share of that window
      (no CUDA kernel event fails the leg).
8. the benchmark harnesses as a user runs them, child processes of
   ``python -m mcevidence_tpu_torch.<module>`` from the checkout:
   a. ``bench`` at its defaults (bench.py's workload, N=65536, d=8,
      kmax=5, 8 runs a timed attempt, 3 attempts): its last line must
      carry bench.py's schema with ``value`` > 0, ``backend`` "cuda",
      ``timed_kernel`` "pallas_packed2", ``knn_select_packed`` launched at
      least runs x attempts times, no CUDA tensor on the plain selection,
      |dlnZ| against the CPU baseline's f64 oracle within 3e-3 (timed
      kernel, fast) and 1e-6 (device), and no part of refine's
      ``refine_split_s`` (the parts of one ``exact_knn`` call) below 0;
      its launches join the main paths' totals.  Then the timed step's 8
      runs in this process under ``torch.profiler``: the device-busy share
      of their window and the CUDA runtime calls that wait (synchronizes,
      copies).
   b. ``bench_serve 2 --clients 1,2`` at ``MCE_SERVE_BENCH_SIZES=
      2000,8000,65536``: every response ``ok`` and in request order.  A
      smoke run of the stream: with 2 requests a size its p50 and p95 are
      one warm request each, and each K's wall is 8 requests; latencies
      come from ``bench_serve`` at its defaults.
   c. ``bench_grid`` on ``write_grid``'s grid, 2 runs in one process, in
      AllChains and with ``-nc 4``: exit 0, and every run's tables within
      1e-6 of ``planck``'s per-cell refine tables of that mode.
   The phase takes 65-95 s on one H100 (six child processes).
9. the validation study at docs/VALIDATION_STUDY.md's seed counts, as a
   user runs it: ``mcevidence_tpu_torch.validation_study.main`` in this
   process with its stdout captured, for ``10`` (the document's command:
   every table at 10 seeds a cell, cross at 40, nested at 10), ``6 cross``
   (the document's cross tables, 24 seeds) and ``8 nested`` (its nested
   table), each with the launch counts set to 0 just before it and read
   just after.  Every printed cell of the document's N, d, correlated,
   cross and nested tables must equal the document's digits
   (``study_document``); every seed of the importance, banana
   and thinned autocorrelated legs within tests/test_examples.py's band
   for its model (0.15 weighted, 0.2 banana), and every seed of the
   unthinned ensemble below its truth (the caveat that leg prints); every
   ln Z finite;
   ``knn_select_small_k`` launched and no CUDA tensor on the plain
   selection.  Then ``python -m mcevidence_tpu_torch.compare_grids``'s
   ``main`` on phase 4c's trees (the defaults' against the per-cell refine
   tables, AllChains and ``-nc 4``) must exit 0 at 1e-6, and on a copy
   with one AllChains cell moved by 1e-5 must not.
10. one card's N envelope: ``python -m mcevidence_tpu_torch.envelope 20 8``
   as a child process (fast and device, warm then timed, at N = 2^17 ..
   2^20, d=8, kmax=5): every point present, |fast - device| <= 3e-3 at
   each, no CUDA tensor on the plain selection; device within 1e-6 of the
   f64 oracle at 2^17 (the oracle's f64 plain selection grows as N^2);
   refine (``evidence_fn`` at its defaults, with the launch counts set to
   0 just before it and read just after) within 1e-6 of device at 2^18,
   2^20 and 1,000,000 rows; ``knn_select_small_k`` timed at N=2^20, d=8,
   k=9 beside its bound, and its selection of 4096 sampled query rows held
   to an f64 brute-force kNN of them on the card within 2^-10, on all
   2^20 rows and with 1,000,000 valid rows (garbage past them) in the
   allocation.

The line before the last is a JSON object of the kernels, each with its
``library_ms`` (the library pair on its first row of phase 5); the last
line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import io
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mcevidence_tpu_torch.kernel_bench import (
    FLOPS_TEXT, KERNELS, LIBRARY_PAIR, cuda_ms, host_ms, packed2_study,
    prologue_gate, prologue_study, self_row, smalld_study)
from mcevidence_tpu_torch.kernel_cert import (
    check_selection, compare, compare_batched, report, tie_order_broken)

DLNZ_TOL = 1e-6               # refine vs f64 oracle, tests/test_evidence.py
FAST_DLNZ_TOL = 3e-3          # fast vs refine, tests/test_evidence.py:169
FAST_GRID_TOL = 5e-3          # fast grid vs refine, tests/test_planck.py:161
HERE = os.path.dirname(os.path.abspath(__file__))
RING_NOTE = "ranks share one card: not a scaling figure"
STUDY_MARGIN = 3.0            # one seed: |lnZ - bias| <= 3 rms
CPU_ROWS_MAX = 16000          # legs held on the CPU too (see phase 7a)
# phase 4a's fresh process: the default refine path, then the libraries it
# loaded and the first call's wall time (the libraries are built already)
DEFAULT_PATH_LIBRARIES = """
import json, time
import chip_smoke
from mcevidence_tpu_torch import evidence_fn
from mcevidence_tpu_torch.ops import _build
theta, lnl = chip_smoke.bench_chain(65536, 8, seed=0)
t0 = time.perf_counter()
evidence_fn(theta, lnl, kmax=5, device="cuda")
print(json.dumps({"loaded": _build.loaded(),
                  "first_call_s": time.perf_counter() - t0}))
"""
GPU_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def bench_chain(n, ndim, seed=0):
    """bench.py:148's synthetic chain: drawn exactly from its own
    normalised Gaussian likelihood."""
    rng = np.random.default_rng(seed)
    mean = np.arange(1.0, ndim + 1.0)
    sigma = np.full(ndim, 0.05)
    theta = rng.normal(mean, sigma, size=(n, ndim))
    dm = (theta - mean) / sigma
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 0.5 * ndim * np.log(2 * np.pi) - np.sum(np.log(sigma)))
    return theta, lnl


def lattice_chain(side=40):
    g = np.arange(side, dtype=np.float64)
    theta = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lnl = -0.5 * np.sum(((theta - (side - 1) / 2) / 8.0) ** 2, axis=1)
    return theta, lnl


def oracle_evidence(theta, lnl, kmax, theta2=None, dev="cuda"):
    """Independent f64 estimator (tests/test_evidence.py:15's formula):
    np.cov whitening, an f64 brute-force kNN on the card, the reference's
    volume/dotp/amax loop over k."""
    from mcevidence_tpu_torch.ops.knn_hopper import knn_select_torch
    cross = theta2 is not None
    all_s = np.concatenate([theta, theta2]) if cross else theta
    cov = np.cov(all_s.T)
    ev, evec = np.linalg.eigh(cov)
    log_jac = 0.5 * math.log(np.linalg.det(cov))
    s = (theta @ evec) / np.sqrt(ev)
    r = (theta2 @ evec) / np.sqrt(ev) if cross else s
    sq = torch.as_tensor(s, dtype=torch.float64, device=dev)
    rq = sq if not cross else torch.as_tensor(r, dtype=torch.float64,
                                              device=dev)
    d2, _ = knn_select_torch(sq, rq, kmax, self_mode=not cross)
    dist = np.sqrt(d2.cpu().numpy())
    n, ndim = theta.shape
    lmax = lnl.max()
    fs = np.exp(lnl - lmax)
    log_c = 0.5 * ndim * math.log(math.pi) - math.lgamma(1 + 0.5 * ndim)
    out = []
    for k in range(1, kmax):
        vol = np.exp(log_c) * dist[:, k] ** ndim
        k_nn = k + 1 if cross else k
        amax = np.dot(vol, fs) / (n * k_nn + 1.0)
        out.append(math.log(n * amax) + log_jac + lmax)
    return np.array(out)


def write_toy_root(tmp, rng):
    n = 3000
    names = ["omegabh2", "omegach2", "tau"]
    mean = np.array([0.0224, 0.12, 0.055])
    sig = np.array([0.0002, 0.002, 0.01])
    with open(os.path.join(tmp, "toy.ranges"), "w") as fh:
        for nm, m, s in zip(names, mean, sig):
            fh.write(f"{nm} {m - 10 * s} {m + 10 * s}\n")
    for c in (1, 2):
        th = rng.normal(mean, sig, size=(n, 3))
        neglnl = (0.5 * np.sum(((th - mean) / sig) ** 2, axis=1)
                  + 1.5 * math.log(2 * math.pi) + np.sum(np.log(sig)))
        np.savetxt(os.path.join(tmp, f"toy_{c}.txt"),
                   np.column_stack([np.ones(n), neglnl, th]))
    return os.path.join(tmp, "toy")


# scripts/synth_grid.py's layout: names in both packages' cosmological
# registries, Gaussian chains drawn from their own normalised likelihood,
# a derived H0* column for the Riess-2016 importance hook
GRID_PARAMS = ["omegabh2", "omegach2", "theta", "tau", "omegak", "mnu", "w",
               "nnu", "yhe"]
GRID_MODELS = [("base", 6, 24000), ("base_omegak", 7, 40000),
               ("base_nnu", 7, 48000), ("base_mnu", 8, 64000)]
GRID_NCHAINS = 4


def write_grid(outdir, datasets, rng):
    """A Planck-shaped grid: every (dataset, model) cell of GRID_MODELS,
    its rows split over GRID_NCHAINS chain files."""
    for ds in datasets:
        for model, ndim, n in GRID_MODELS:
            d = os.path.join(outdir, model, ds)
            os.makedirs(d, exist_ok=True)
            root = os.path.join(d, f"{model}_{ds}")
            mean = np.linspace(1.0, 2.0, ndim)
            sig = np.full(ndim, 0.05)
            for c in range(1, GRID_NCHAINS + 1):
                nc = n // GRID_NCHAINS
                theta = rng.normal(mean, sig, size=(nc, ndim))
                dm = (theta - mean) / sig
                neglnl = (0.5 * np.sum(dm * dm, axis=1)
                          + 0.5 * ndim * np.log(2 * np.pi)
                          + np.sum(np.log(sig)))
                h0 = rng.normal(70.0, 3.0, size=nc)
                np.savetxt(f"{root}_{c}.txt",
                           np.column_stack([np.ones(nc), neglnl, theta, h0]),
                           fmt="%.7e")
            with open(root + ".ranges", "w") as fh:
                for nm, mu in zip(GRID_PARAMS[:ndim], mean):
                    fh.write(f"{nm} {mu - 0.5:.6g} {mu + 0.5:.6g}\n")
                fh.write("nuis1 0 0\n")
            with open(root + ".paramnames", "w") as fh:
                fh.writelines(f"{nm}\t{nm}\n" for nm in GRID_PARAMS[:ndim])
                fh.write("H0*\tH_0\n")


class StageLog(logging.Handler):
    """Collects the grid driver's per-dataset stage records (the seconds
    of each stage span and the counts, ``planck._stage_log``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages = []

    def emit(self, record):
        if record.getMessage().startswith("dataset stages"):
            self.stages.append(dict(record.args))


def run_cli(argv):
    from mcevidence_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = [ln.strip() for ln in buf.getvalue().splitlines()
             if ln.strip().startswith("ln(B)[k=")]
    vals = [float(ln.split("=", 2)[2]) for ln in lines]
    if rc != 0 or not vals or not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"cli {argv}: rc={rc}, ln(B) lines {lines}")
    return vals


def hold_to_oracle(name, got, want, tol=DLNZ_TOL):
    got, want = np.asarray(got), np.asarray(want)
    dlnz = float(np.max(np.abs(got - want)))
    ok = bool(got.shape == want.shape and np.all(np.isfinite(got))
              and dlnz <= tol)
    phase(name, lnz=got.tolist(), oracle=want.tolist(), max_abs_dlnz=dlnz,
          tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: |dlnZ| {dlnz} > {tol}")


class Counted:
    """Launch counts of one main path: set to 0 on entry, read on exit,
    with the count of CUDA tensors that reached the plain selection
    (``plain_on_card``)."""

    def __init__(self, name, total):
        self.name, self.total = name, total

    def __enter__(self):
        from mcevidence_tpu_torch.ops import knn_hopper as kh
        self.kh = kh
        kh.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.counts = {n: getattr(self.kh, n).launches for n in KERNELS}
        self.plain_on_card = self.kh.plain_cuda_calls
        if exc[0] is None:
            phase("launches", path=self.name, **self.counts)
            for n, c in self.counts.items():
                self.total[n] += c
        return False

    def require(self, *names):
        for n in names:
            if self.counts[n] == 0:
                raise AssertionError(f"{self.name}: {n} was never launched")


def read_tables(outdir, mode, datasets):
    import pandas as pd
    return {ds: pd.read_csv(os.path.join(outdir, mode, "csv",
                                         f"mce_{ds}.csv"), index_col=0)
            for ds in datasets}


def tables_gap(label, got, want, datasets):
    """Largest |dlnZ| between two sets of grid tables whose layout and
    info columns must be equal."""
    worst = 0.0
    for ds in datasets:
        g, w = got[ds], want[ds]
        if (list(g.index) != list(w.index)
                or list(g.columns) != list(w.columns)):
            raise AssertionError(f"grid {label} {ds}: table layout")
        for col in ("PriorVol", "ndim", "N_read", "N_used"):
            if list(g[col]) != list(w[col]):
                raise AssertionError(f"grid {label} {ds}: {col}")
        lnz = [col for col in w.columns if col.startswith("chain")
               or col.startswith("AllChains")]
        a, b = g[lnz].to_numpy(float), w[lnz].to_numpy(float)
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"grid {label} {ds}: non-finite")
        worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def body_name(kernel):
    """A selection body's name from its mangled kernel name: "small
    Padded<8>", "large Compact<3>", "wide A Padded<8> N=16 warps=16" (the
    warp-queue body: keys a lane, warps a block), "wide B TruncKey<11>
    shared" (the list body: key, where its lists live); None for others."""
    lay = re.search(r"(Padded|Compact)ILi(\d+)E", kernel)
    kind = ("small" if "small_k_kernel" in kernel else
            "large" if "large_k_kernel" in kernel else None)
    if kind and lay:
        return f"{kind} {lay.group(1)}<{lay.group(2)}>"
    m = re.search(r"knn_warp_kernelILi(\d+)ELi(\d+)ELi(\d+)E", kernel)
    if m:
        return f"wide A Padded<{m.group(1)}> N={m.group(2)} warps={m.group(3)}"
    m = re.search(r"knn_list_kernelIN3knn(?:8ExactKey|8TruncKeyILi(\d+)EE)"
                  r"ELb([01])E", kernel)
    if m:
        key = f"TruncKey<{m.group(1)}>" if m.group(1) else "ExactKey"
        return f"wide B {key} {'workspace' if m.group(2) == '1' else 'shared'}"
    return None


def resource_table(log):
    """Max registers and spill bytes of each selection body on each layout
    (the wide bodies on each key), from nvcc's ``--resource-usage`` log:
    "small Padded<8>": {...}, "wide A Padded<8> N=16 warps=16": {...}."""
    table, body = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Function properties for|Compiling entry function)"
                      r"\W*(\w+)", line)
        if m:
            body = body_name(m.group(1))
            continue
        if body is None:
            continue
        ent = table.setdefault(body, {"max_registers": 0, "spill_bytes": 0})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            ent["max_registers"] = max(ent["max_registers"], int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            ent["spill_bytes"] += int(m.group(1))
    return table


def ring_call(fn, *args, **kwargs):
    """On a rank of the ring: the launch counts set to 0, ``fn(*args,
    **kwargs)``, the counts read; returns (result, counts, seconds)."""
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)
    sync()
    kh.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync()
    return (out, {n: getattr(kh, n).launches for n in KERNELS},
            time.perf_counter() - t0)


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ring_cells():
    """The synthetic grid's cells (GRID_MODELS: d = 6/7/7/8, 24000-64000
    rows), drawn in memory as ``write_grid`` draws them."""
    rng = np.random.default_rng(20261016)
    cells = []
    for _, ndim, n in GRID_MODELS:
        mean = np.linspace(1.0, 2.0, ndim)
        sig = np.full(ndim, 0.05)
        theta = rng.normal(mean, sig, size=(n, ndim))
        dm = (theta - mean) / sig
        cells.append((theta, -0.5 * np.sum(dm * dm, axis=1)
                      - 0.5 * ndim * np.log(2 * np.pi)
                      - np.sum(np.log(sig))))
    return cells


def ring_phase(total, smi, theta, lnl, one_card, dev="cuda:0"):
    """Phase 6: the ring on 2 and 4 ranks of one gloo group, each rank a
    process on the one card (NCCL takes one card a rank).  Every leg runs
    on all ranks with the counts set to 0 on each, must give the same
    answer on every rank, within its gate of the one-card answer (refine
    1e-9, device 1e-8, fast 3e-3), and launch its kernel; then
    ``dryrun_multichip(4)`` on the card and ``planck --distributed`` on 2
    ranks against the one-process tables.  The times share one card and
    its host: no scaling figure."""
    from mcevidence_tpu_torch import planck
    from mcevidence_tpu_torch.graft_entry import dryrun_multichip
    from mcevidence_tpu_torch.parallel import ring
    from mcevidence_tpu_torch.parallel.launch import RankPool
    half = theta.shape[0] // 2
    cells = ring_cells()
    same_d = [c for c, (_, d, _) in zip(cells, GRID_MODELS) if d == 7]
    t0 = time.perf_counter()
    one_grid = {
        "refine": ring.sharded_grid_evidence_refine(cells, kmax=2,
                                                    device=dev),
        "device": ring.sharded_grid_device_refine_evidence(cells, kmax=2,
                                                           device=dev),
        "fast": ring.sharded_grid_auto_evidence(same_d, kmax=2, device=dev)}
    phase("ring_one_card_grid", seconds=time.perf_counter() - t0,
          cells=[[m, d, n] for m, d, n in GRID_MODELS], gpu=smi)
    small, batched = "knn_select_small_k", "knn_select_batched"
    legs = [
        ("auto refine N=65536 d=8 kmax=5", ring.sharded_auto_evidence,
         (theta, lnl), dict(kmax=5, precision="refine"), one_card["refine"],
         1e-9, small),
        ("auto fast N=65536 d=8 kmax=5", ring.sharded_auto_evidence,
         (theta, lnl), dict(kmax=5), one_card["fast"], FAST_DLNZ_TOL, small),
        ("cross refine 32768 x 32768 d=8 kmax=5",
         ring.sharded_cross_evidence,
         (theta[:half], lnl[:half], theta[half:]),
         dict(kmax=5, precision="refine"), one_card["cross"], 1e-9, small),
        ("auto device N=65536 d=8 kmax=5",
         ring.sharded_device_refine_evidence, (theta, lnl), dict(kmax=5),
         one_card["device"], 1e-8, small)]
    grid_legs = [
        ("grid refine 2x2, 4 cells d=6-8", ring.sharded_grid_evidence_refine,
         (cells,), dict(kmax=2, dp=2), one_grid["refine"], 1e-9, batched),
        ("grid device 2x2, 4 cells d=6-8",
         ring.sharded_grid_device_refine_evidence, (cells,),
         dict(kmax=2, dp=2), one_grid["device"], 1e-8, batched),
        ("grid fast 2x2, 2 cells d=7", ring.sharded_grid_auto_evidence,
         (same_d,), dict(kmax=2, dp=2), one_grid["fast"], FAST_DLNZ_TOL,
         batched)]
    for n_ranks in (2, 4):
        t0 = time.perf_counter()
        with RankPool(n_ranks, timeout=600) as pool:
            # each rank's CUDA context and kernel library, outside the legs
            pool.run(ring_call, torch.zeros, 1, device=dev)
            phase("ring_pool", ranks=n_ranks,
                  start_s=time.perf_counter() - t0, note=RING_NOTE)
            for label, fn, args, kw, want, tol, kernel in (
                    legs + (grid_legs if n_ranks == 4 else [])):
                # twice: the first call also loads each rank's libraries
                # (cuSOLVER for the fast path's eigh)
                first = pool.run(ring_call, fn, *args, device=dev, **kw)
                got = pool.run(ring_call, fn, *args, device=dev, **kw)
                got = [(g[0], {n: g[1][n] + f[1][n] for n in KERNELS}, g[2],
                        f[2]) for f, g in zip(first, got)]
                res = [np.asarray(g[0]) for g in got]
                counts = {n: sum(g[1][n] for g in got) for n in KERNELS}
                agree = all(np.array_equal(r, res[0], equal_nan=True)
                            for r in res)
                gap = float(np.max(np.abs(res[0] - np.asarray(want))))
                ok = bool(agree and np.all(np.isfinite(res[0]))
                          and gap <= tol
                          and (counts[kernel] > 0 or dev == "cpu"))
                phase("ring", ranks=n_ranks, leg=label, lnz=res[0].tolist(),
                      one_card=np.asarray(want).tolist(),
                      max_abs_dlnz_vs_one_card=gap, tol=tol,
                      ranks_agree=agree, launches=counts,
                      first_s=max(g[3] for g in got),
                      seconds=max(g[2] for g in got), note=RING_NOTE,
                      gpu=smi, ok=ok)
                if not ok:
                    raise AssertionError(f"ring {n_ranks} ranks {label}: "
                                         f"gap {gap} > {tol}, agree {agree},"
                                         f" launches {counts}")
                for n in KERNELS:
                    total[n] += counts[n]
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device="cpu" if dev == "cpu" else "cuda",
                           timeout=600)
    phase("dryrun_multichip", ranks=4, seconds=time.perf_counter() - t0,
          max_abs_dlnz_vs_one_card=dry["max_abs_dlnz_vs_one_card"],
          note=RING_NOTE, gpu=smi, ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        datasets = planck.DATASETS[:2]
        grid = os.path.join(tmp, "grid")
        write_grid(grid, datasets, np.random.default_rng(7))
        base = ["--rootdir", grid, "-v", "0", "-nd", "2"]
        one, two = os.path.join(tmp, "one"), os.path.join(tmp, "two")
        if planck.main(base + ["-o", one, "--device", dev]) != 0:
            raise AssertionError("planck one process: nonzero exit")
        env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mcevidence_tpu_torch.planck", *base,
             "-o", two, "--device", dev, "--distributed"], cwd=HERE,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"planck --distributed rank {r}: exit "
                                     f"{p.returncode}\n{err[-3000:]}")
        gap = tables_gap("distributed", read_tables(two, "AllChains",
                                                    datasets),
                         read_tables(one, "AllChains", datasets), datasets)
        ok = gap <= 1e-8
        phase("planck_distributed", ranks=2, datasets=datasets,
              max_abs_dlnz_vs_one_process=gap, tol=1e-8, wall_s=wall,
              note=RING_NOTE, gpu=smi, ok=ok)
        if not ok:
            raise AssertionError(f"planck --distributed: |dlnZ| {gap}")


def validation_legs(tmp, dev="cuda", scale=1):
    """Phase 7a's legs: (name, rows a side, call(device, engine) -> lnZ,
    oracle thunk or None, [(column, truth, band)]).  ``scale`` divides the
    row counts, for a rehearsal on the CPU."""
    from mcevidence_tpu_torch import MCEvidence, evidence_fn
    from mcevidence_tpu_torch import examples as ex
    from mcevidence_tpu_torch.chains.nested import load_nested_chains
    from mcevidence_tpu_torch.validation_study import chain as study_chain

    def facade(chain, **kw):
        return lambda dev, eng: MCEvidence(chain, kmax=2, verbose=0,
                                           device=dev, engine=eng,
                                           **kw).evidence()

    def unweighted(th, lnl, kmax=2, shift=0.0, th2=None):
        return lambda: oracle_evidence(th, lnl, kmax, theta2=th2,
                                       dev=dev) + shift

    legs = []
    # tests/test_examples.py's bands, at scripts/validation_study.py's sizes
    # and, where the study has the cell, its first seed
    m = ex.gaussian_eg(ndim=6, verbose=0, rng=np.random.default_rng(701))
    th, lnl = m.Sampler(32000 // scale)
    legs.append(("gaussian_eg d=6", len(th),
                 facade({"samples": th, "loglikes": lnl}),
                 unweighted(th, lnl), [(0, 0.0, 0.2)]))
    for d in (6, 10):
        m = ex.gaussian_corr_eg(ndim=d, verbose=0,
                                rng=np.random.default_rng(7000 * d))
        th, lnl = m.Sampler(32000 // scale)
        legs.append((f"gaussian_corr_eg d={d}", len(th),
                     facade({"samples": th, "loglikes": lnl}, ischain=True),
                     unweighted(th, lnl), [(0, 0.0, 0.15)]))
    m = ex.banana_eg(verbose=0, rng=np.random.default_rng(9000 + 128000))
    th, lnl = m.Sampler(128000 // scale)
    legs.append(("banana_eg", len(th),
                 facade({"samples": th, "loglikes": lnl}, ischain=True,
                        priorvolume=m.prior_volume),
                 unweighted(th, lnl, shift=-math.log(m.prior_volume)),
                 [(0, m.evidence(), 0.2)]))
    # burn-in off, so that the oracle sees the rows the estimate sees
    m = ex.glm_eg(verbose=0, rng=np.random.default_rng(12345))
    th, lnl = m.Sampler(nsamples=4000 // scale)
    vol = float(m.ptheta.prod())
    legs.append(("glm_eg Gibbs", len(th),
                 facade({"samples": th, "loglikes": lnl}, priorvolume=vol),
                 unweighted(th, lnl, shift=-math.log(vol)),
                 [(0, m.evidence(), 0.3)]))
    # importance weights w = p/q from a 1.5x wider proposal: no oracle (it
    # is unweighted)
    d, n, c = 4, 32000 // scale, 1.5
    rng = np.random.default_rng(3000 + 150)
    mean, sig = np.linspace(1.0, 2.0, d), np.full(d, 0.05)
    lognorm = -0.5 * d * math.log(2 * math.pi) - np.sum(np.log(sig))
    thw = rng.normal(mean, c * sig, size=(n, d))
    lnlw = -0.5 * np.sum(((thw - mean) / sig) ** 2, axis=1) + lognorm
    lnq = (-0.5 * np.sum(((thw - mean) / (c * sig)) ** 2, axis=1) + lognorm
           - d * math.log(c))
    ww = np.exp(lnlw - lnq)
    legs.append(("importance-weighted d=4", n,
                 lambda dev, eng: evidence_fn(thw, lnlw, ww, kmax=2,
                                              device=dev, engine=eng),
                 None, [(0, 0.0, 0.15)]))
    # cross: one chain of N split in two halves (validation_study.py's
    # cross_leg)
    rng = np.random.default_rng(5000 + 32000 + 8)
    n = 32000 // scale
    thc, lnlc = study_chain(rng, n, 8)
    perm = rng.permutation(n)
    i1, i2 = perm[:n // 2], perm[n // 2:]
    legs.append(("cross d=8", n // 2,
                 lambda dev, eng: evidence_fn(thc[i1], lnlc[i1],
                                              samples2=thc[i2], kmax=2,
                                              device=dev, engine=eng),
                 unweighted(thc[i1], lnlc[i1], th2=thc[i2]),
                 [(0, 0.0, 0.2)]))
    # a true nested-sampling run written as MultiNest products and read
    # back: the equal-weights rows (tests/test_nested.py's band 0.35) and
    # the weighted dead points (that test asserts only finiteness)
    for nd, seed in ((2, 0), (4, 100)):
        m = ex.nested_eg(ndim=nd, verbose=0, rng=np.random.default_rng(seed))
        os.makedirs(os.path.join(tmp, f"nested_d{nd}"))
        root = m.write_products(os.path.join(tmp, f"nested_d{nd}"))
        vol = m.prior_volume
        for eq in (True, False):
            chains = load_nested_chains(root, equal_weights=eq)
            rows = chains[0].shape[0]
            if eq:
                if not np.all(chains[0][:, 0] == 1.0):
                    raise AssertionError("equal-weights rows not unit")
                oracle = unweighted(chains[0][:, 2:], -chains[0][:, 1],
                                    shift=-math.log(vol))
                truth = [(0, m.evidence(), 0.35)]
            else:
                oracle, truth = None, [(0, m.evidence(), math.inf)]
            legs.append((f"nested_eg d={nd} "
                         f"{'equal-weights' if eq else 'weighted'}", rows,
                         facade(chains, priorvolume=vol), oracle, truth))
    # the sweeps in device precision, each within 3 rms of the bias that
    # docs/VALIDATION_STUDY.md prints (phase 9 reproduces its tables)
    doc = study_document()
    for n, (b, r) in sorted(doc["convergence"].items()):
        th, lnl = study_chain(np.random.default_rng(4000 + n), n // scale,
                              4)
        b, r = float(b), float(r)
        legs.append((f"N sweep d=4 N={n} device", len(th),
                     functools.partial(
                         lambda th, lnl, dev, eng: evidence_fn(
                             th, lnl, kmax=2, precision="device", device=dev,
                             engine=eng), th, lnl),
                     unweighted(th, lnl), [(0, b, STUDY_MARGIN * r)]))
    for d, cells in sorted(doc["dimension"].items()):
        th, lnl = study_chain(np.random.default_rng(1000 * d + 32000),
                              32000 // scale, d)
        b1, r1, b4, r4 = map(float, cells)
        legs.append((f"d sweep N=32000 d={d} device", len(th),
                     functools.partial(
                         lambda th, lnl, dev, eng: evidence_fn(
                             th, lnl, kmax=5, precision="device", device=dev,
                             engine=eng), th, lnl),
                     unweighted(th, lnl, kmax=5),
                     [(0, b1, STUDY_MARGIN * r1), (3, b4, STUDY_MARGIN * r4)]))
    return legs


def trace_summary(path):
    """A Chrome trace's CUDA kernel time by name (us), its window (us,
    first to last event) and the device-busy share of that window (the
    union of kernel, copy and set spans)."""
    with open(path) as fh:
        spans = [e for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "X" and "dur" in e]
    kernels = {}
    for e in spans:
        if e.get("cat") == "kernel":
            name = e["name"] if len(e["name"]) <= 96 else e["name"][:93] + "..."
            kernels[name] = kernels.get(name, 0.0) + float(e["dur"])
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    busy, end = 0.0, -math.inf
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in spans if e.get("cat") in GPU_EVENT_CATS):
        if b > end:
            busy += b - max(a, end)
            end = b
    return kernels, hi - lo, busy


def validation_phase(total, smi, theta, lnl, dev="cuda", scale=1):
    """7. The validation path on the card; each leg with the launch counts
    set to 0 just before it and read just after.  ``dev="cpu"`` with a
    ``scale`` > 1 rehearses the phase's control flow on a host without a
    card (the kernels' plain versions, no launches, no CUDA events)."""
    from mcevidence_tpu_torch import MCEvidence, samplers
    from mcevidence_tpu_torch import examples as ex
    t_phase = time.perf_counter()

    # 7a. the examples' chains through MCEvidence and evidence_fn
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        legs = validation_legs(tmp, dev, scale)
    setup_s = time.perf_counter() - t0
    t_legs = time.perf_counter()
    got = {}
    with Counted("validation: the examples' chains", total) as c:
        for name, _, call, _, _ in legs:
            got[name] = call(dev, "auto")
    c.require("knn_select_small_k")
    cpu_s = {}
    for name, rows, call, oracle, truth in legs:
        lnz = got[name]
        plain = call(dev, "torch")
        gaps = {"plain_on_card": float(np.max(np.abs(lnz - plain)))}
        if rows <= CPU_ROWS_MAX:
            t0 = time.perf_counter()
            gaps["cpu"] = float(np.max(np.abs(lnz - call("cpu", "auto"))))
            cpu_s[name] = time.perf_counter() - t0
        if oracle is not None:
            gaps["oracle"] = float(np.max(np.abs(lnz - oracle())))
        bands = [{"k": col + 1, "truth": t, "band": b,
                  "gap": float(lnz[col] - t)} for col, t, b in truth]
        ok = bool(np.all(np.isfinite(lnz))
                  and max(gaps.values()) <= DLNZ_TOL
                  and all(abs(x["gap"]) <= x["band"] for x in bands))
        phase("validation", leg=name, rows=rows, lnz=lnz.tolist(),
              max_abs_dlnz=gaps, tol=DLNZ_TOL,
              truth=[{**x, "band": None if math.isinf(x["band"])
                      else x["band"]} for x in bands],
              cpu_s=cpu_s.get(name), ok=ok)
        if not ok:
            raise AssertionError(f"validation {name}: gaps {gaps}, truth "
                                 f"{bands}")
    legs_s = time.perf_counter() - t_legs

    # 7b. NUTS with its gradients on the card, under the asserts of
    # tests/test_examples.py:69-83, beside the same sampling on the host
    nuts_runs = {}
    for where in (dev, "cpu"):
        nuts = ex.glm_nuts(seed=3, device=where)
        f = samplers._make_vgrad(nuts.lnprob, where)
        x0 = nuts.model.theta_sample.copy()
        f(x0)
        evals = []
        for _ in range(200):
            t0 = time.perf_counter()
            f(x0)
            evals.append(time.perf_counter() - t0)
        # the sampler evaluates lnprob once a gradient: count them
        calls, lnprob = [0], nuts.lnprob

        def counted(x, lnprob=lnprob, calls=calls):
            calls[0] += 1
            return lnprob(x)
        nuts.lnprob = counted
        t0 = time.perf_counter()
        draws = nuts.Sampler(nsamples=2500 // scale)
        nuts_runs[where] = (nuts, draws, statistics.median(evals),
                            time.perf_counter() - t0, calls[0])
    nuts, (samples, lnp), *_ = nuts_runs[dev]
    sig = np.sqrt(np.diag(np.linalg.inv(nuts.model.D.T @ nuts.model.D)))
    dmean = np.abs(samples.mean(axis=0) - nuts.model.theta_sample) / sig
    with Counted("validation: glm_nuts ln Z", total) as c:
        nuts_lnz = MCEvidence({"samples": samples, "loglikes": lnp},
                              verbose=0, priorvolume=float(nuts.ptheta.prod()),
                              kmax=2, device=dev).evidence()
    c.require("knn_select_small_k")
    truth = nuts.evidence()
    ok = bool(np.all(dmean < 6.0) and abs(nuts_lnz[0] - truth) < 0.3)
    phase("nuts", model="glm_nuts seed=3, 2500 draws, 400 warmup",
          mean_gap_in_sigma=dmean.tolist(), lnz=nuts_lnz.tolist(),
          truth=truth, band=0.3,
          warm_eval_s={d: r[2] for d, r in nuts_runs.items()},
          sampling_wall_s={d: r[3] for d, r in nuts_runs.items()},
          sampling_evals={d: r[4] for d, r in nuts_runs.items()},
          same_draws_cuda_cpu=bool(np.array_equal(
              samples, nuts_runs["cpu"][1][0])), gpu=smi, ok=ok)
    if not ok:
        raise AssertionError(f"glm_nuts on the card: mean gap {dmean} "
                             f"sigma, lnZ {nuts_lnz} vs {truth}")

    # 7c. the examples' CLI, two child processes on the card (their launch
    # counts stay in their processes)
    t0 = time.perf_counter()
    on_host = [] if dev == "cuda" else ["--device", dev]
    procs = {args[0]: subprocess.Popen(
        [sys.executable, "-m", "mcevidence_tpu_torch.examples", *args,
         *on_host], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for args in (["gaussian_eg", str(32000 // scale)], ["nested_eg"])}
    outs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            outs[name] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want = {"gaussian_eg": ("estimated ln Z", "analytic ln Z"),
            "nested_eg": ("estimated ln Z", "nested run's own ln Z",
                          "analytic ln Z")}
    for name, (rc, out, err) in outs.items():
        ok = rc == 0 and all(s in out for s in want[name])
        phase("examples_cli", method=name, rc=rc,
              lines=[ln for ln in out.splitlines() if "ln Z" in ln],
              ok=ok)
        if not ok:
            raise AssertionError(f"examples {name}: rc={rc}\n{out}\n"
                                 f"{err[-2000:]}")
    cli_s = time.perf_counter() - t0

    # 7d. the MCE_PROFILE_DIR trace of MCEvidence.evidence(profile=True)
    t0 = time.perf_counter()
    chain = {"samples": theta, "loglikes": lnl}
    with tempfile.TemporaryDirectory() as tmp, \
            Counted("validation: traced MCEvidence", total) as c:
        for prec in ("refine", "device", "fast"):
            mce = MCEvidence(chain, kmax=5, verbose=0, precision=prec,
                             device=dev)
            plain = mce.evidence()
            os.environ["MCE_PROFILE_DIR"] = os.path.join(tmp, prec)
            try:
                traced = mce.evidence(profile=True)
            finally:
                del os.environ["MCE_PROFILE_DIR"]
            (path,) = [os.path.join(tmp, prec, p)
                       for p in os.listdir(os.path.join(tmp, prec))]
            kernels, window, busy = trace_summary(path)
            same = bool(np.array_equal(traced, plain))
            ok = same and (bool(kernels) or dev == "cpu")
            phase("trace", precision=prec,
                  shape=f"MCEvidence auto N={theta.shape[0]} "
                        f"d={theta.shape[1]} kmax=5",
                  kernel_us=kernels, window_us=window, device_busy_us=busy,
                  device_busy_share=busy / window, bit_equal_untraced=same,
                  trace_bytes=os.path.getsize(path), gpu=smi, ok=ok)
            if not ok:
                raise AssertionError(f"trace {prec}: bit-equal {same}, "
                                     f"CUDA kernel events {len(kernels)}")
    c.require("knn_select_small_k")
    phase("validation_seconds", setup_s=setup_s, legs_s=legs_s,
          nuts_s=sum(r[3] for r in nuts_runs.values()), cli_s=cli_s,
          trace_s=time.perf_counter() - t0,
          total_s=time.perf_counter() - t_phase, cpu_leg_s=cpu_s, gpu=smi)


# 8a's bench line: bench.py's schema (bench.py:368-385) under the port's
# names, and the fields the port adds
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "timed_rep_walls_s",
                "device_wall_s", "sklearn_cpu_wall_s", "baseline_impl",
                "backend", "gpu", "workload",
                "max_abs_dlnz_vs_f64_oracle_timed_kernel", "timed_kernel",
                "max_abs_dlnz_vs_f64_oracle_fast_mode",
                "max_abs_dlnz_vs_f64_oracle_device_mode",
                "device_mode_wall_s_incl_host_prep", "evidence_fn_wall_s",
                "refine_split_s", "launches")
# 8b's stream: three of bench_serve's sizes, 2 requests a size
SERVE_BENCH_SIZES = "2000,8000,65536"
# CUDA runtime calls of a trace that wait for the card, or may
RUNTIME_WAITS = ("Synchronize", "cudaMemcpy")


def harness(module, args, env=None, timeout=900):
    """``python -m mcevidence_tpu_torch.<module> *args`` as a child process
    from the checkout; returns (exit code, last stdout line as JSON or None,
    stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"mcevidence_tpu_torch.{module}", *args],
        capture_output=True, text=True, cwd=HERE, timeout=timeout,
        env=dict(os.environ, **(env or {})))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    return proc.returncode, line, proc.stdout, proc.stderr, seconds


def runtime_waits(path):
    """The CUDA runtime calls of a Chrome trace that wait for the card or
    may (synchronizes and copies), counted by name and by the innermost
    operator that issued them ("<call> in <operator>")."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    calls = {}
    for e in events:
        if e.get("cat") != "cuda_runtime" or not any(
                w in e.get("name", "") for w in RUNTIME_WAITS):
            continue
        t = float(e["ts"])
        inside = [o for o in ops if o.get("tid") == e.get("tid")
                  and float(o["ts"]) <= t <= float(o["ts"]) + float(o["dur"])]
        op = min(inside, key=lambda o: float(o["dur"]))["name"] \
            if inside else "no operator"
        key = f"{e['name']} in {op}"
        calls[key] = calls.get(key, 0) + 1
    return calls


def bench_phase(total, smi, dev="cuda", env=None, refs=None):
    """8. The benchmark harnesses through the user's entry points, as child
    processes: ``mcevidence_tpu_torch.bench`` at its defaults (8a, with a
    profiler trace of its timed step in this process), ``bench_serve``
    (8b) and ``bench_grid`` on the synthetic grid (8c), held to the
    ``planck``'s per-cell refine tables of each mode: ``refs`` (phase 4c's, of
    the same grid, keyed "AllChains" and "-nc 4"), or computed here.
    ``dev="cpu"`` with ``env`` (the harnesses' size overrides) rehearses the
    phase's control flow on a host without a card."""
    from mcevidence_tpu_torch import bench, planck
    on_card = dev != "cpu"
    dev_args = [] if on_card else ["--device", "cpu"]
    t_phase = time.perf_counter()

    # 8a. the bench line, held to its gates
    rc, line, out, err, child_s = harness("bench", dev_args, env)
    if rc != 0 or line is None or "error" in line:
        raise AssertionError(f"bench: exit {rc}, line {line}\n"
                             f"{err[-3000:]}")
    reps = int(line["workload"].rsplit("reps=", 1)[1])
    attempts = len(line["timed_rep_walls_s"])
    launches = line["launches"]
    gates = {
        "schema": all(f in line for f in BENCH_FIELDS),
        "value": line["value"] > 0,
        "backend": line["backend"] == ("cuda" if on_card else "cpu"),
        "timed_kernel": line["timed_kernel"] == (
            bench.TIMED_ENGINE if on_card else "plain"),
        "timed_launches": (not on_card or launches["knn_select_packed"]
                           >= reps * attempts),
        "plain_on_cuda": launches["plain_on_cuda"] == 0,
        # the parts of one exact_knn call fit in its wall
        "refine_split": min(line["refine_split_s"][k] for k in
                            ("kernel", "host_refine", "reselect", "rest"))
            >= 0,
        "dlnz_timed_kernel":
            line["max_abs_dlnz_vs_f64_oracle_timed_kernel"] <= FAST_DLNZ_TOL,
        "dlnz_fast": line["max_abs_dlnz_vs_f64_oracle_fast_mode"]
            <= FAST_DLNZ_TOL,
        "dlnz_device": line["max_abs_dlnz_vs_f64_oracle_device_mode"]
            <= DLNZ_TOL}
    ok = all(gates.values())
    phase("bench", **line, gates=gates, child_s=child_s, ok=ok)
    if not ok:
        raise AssertionError(f"bench: gates {gates}")
    for name in KERNELS:
        total[name] += launches[name]

    # the timed step under the profiler: do the REPS runs follow each other
    # on the card, and what waits between them
    n = int(line["workload"].split("N=")[1].split()[0])
    theta, lnl = bench.synthetic_chain(n, bench.NDIM)
    tensors = bench.chain_tensors(theta, lnl, dev)
    bench.evidence_reps(*tensors, reps)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp, \
            Counted("bench timed step, traced", total) as c:
        path = os.path.join(tmp, "bench_trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            float(bench.evidence_reps(*tensors, reps)[0])
        prof.export_chrome_trace(path)
        kernels, window, busy = trace_summary(path)
        waits = runtime_waits(path)
    if on_card:
        c.require("knn_select_packed")
    phase("bench_trace", shape=f"{reps} runs of the timed step, "
          f"N={n} d={bench.NDIM} kmax={bench.KMAX}", window_us=window,
          device_busy_us=busy, device_busy_share=busy / window,
          kernel_us=kernels, runtime_waits=waits, gpu=smi)

    # 8b. the service stream and its concurrency leg
    serve_env = dict(env or {})
    serve_env.setdefault("MCE_SERVE_BENCH_SIZES", SERVE_BENCH_SIZES)
    sizes = serve_env["MCE_SERVE_BENCH_SIZES"].split(",")
    rc, line, out, err, child_s = harness(
        "bench_serve", ["2", "--clients", "1,2", *dev_args], serve_env)
    ok = bool(rc == 0 and line is not None
              and sorted(line["sizes"]) == sorted(sizes)
              and all(v["requests"] == 2 for v in line["sizes"].values())
              and [leg["clients"] for leg in line["concurrency"]["legs"]]
              == [1, 2])
    phase("bench_serve", **(line or {}), child_s=child_s, ok=ok)
    if not ok:
        raise AssertionError(f"bench_serve: exit {rc}, line {line}\n"
                             f"{err[-3000:]}")

    # 8c. ``planck.main`` at its defaults, cold and warm, against the
    # per-cell refine tables of each mode
    datasets = planck.DATASETS[:2]
    with tempfile.TemporaryDirectory() as tmp:
        grid = os.path.join(tmp, "grid")
        write_grid(grid, datasets, np.random.default_rng(20261016))
        for nchain, mode, label in ((0, "AllChains", "AllChains"),
                                    (4, "SingleChains", "-nc 4")):
            if refs is None or label not in refs:
                ref_out = os.path.join(tmp, "ref_" + mode)
                extra = ["-nc", str(nchain)] if nchain else []
                rc = planck.main(["--rootdir", grid, "-v", "0", "-nd",
                                  str(len(datasets)), "-o", ref_out,
                                  "--no-batch-cells", "--precision",
                                  "refine", "--device", dev] + extra)
                if rc != 0:
                    raise AssertionError(f"bench_grid {label} refine: "
                                         f"exit {rc}")
            ref = (refs[label] if refs is not None and label in refs
                   else read_tables(ref_out, mode, datasets))
            rc, line, out, err, child_s = harness(
                "bench_grid", [grid, os.path.join(tmp, "out_" + mode),
                               str(nchain), "2", *dev_args], env)
            if rc != 0 or line is None:
                raise AssertionError(f"bench_grid {label}: exit {rc}\n"
                                     f"{err[-3000:]}")
            gaps = [tables_gap(f"bench_grid {label} run {r['run']}",
                               read_tables(r["out"], mode, datasets), ref,
                               datasets) for r in line["runs"]]
            ok = all(r["rc"] == 0 for r in line["runs"]) and max(gaps) \
                <= DLNZ_TOL
            phase("bench_grid", **line,
                  max_abs_dlnz_vs_refine_per_cell=gaps, tol=DLNZ_TOL,
                  child_s=child_s, ok=ok)
            if not ok:
                raise AssertionError(f"bench_grid {label}: |dlnZ| {gaps}")
    phase("bench_seconds", total_s=time.perf_counter() - t_phase, gpu=smi)


# 9. the validation study at docs/VALIDATION_STUDY.md's seed counts: its
# command (every table; cross then runs 40 seeds a cell and nested 10, which
# the document does not print), then its cross tables (24 seeds) and its
# nested table (8)
STUDY_RUNS = (("10",), ("6", "cross"), ("8", "nested"))
STUDY_DOCUMENTED = {("10",): ("convergence", "dimension", "correlated"),
                    ("6", "cross"): ("cross_split", "cross_matched"),
                    ("8", "nested"): ("nested",)}
STUDY_DOC = os.path.join(HERE, "docs", "VALIDATION_STUDY.md")
# the document's tables in the order it prints them: each table's name, the
# columns that key a row (as its header names them and as the study module's
# rows hold them), and the first cell of a module's row that the document
# prints (it prints no mean ln Z column)
STUDY_TABLES = (("convergence", ("N",), 1), ("dimension", ("d",), 1),
                ("correlated", ("d",), 1), ("cross_split", ("N", "d"), 2),
                ("cross_matched", ("N", "d"), 2),
                ("nested", ("d", "input"), 3))
# the nested table's inputs: the study module's name, the document's text
NESTED_INPUTS = (("equal-weights", "equal-weights rows"),
                 ("weighted dead-point", "weighted dead-point rows"),
                 ("NS own estimate", "the NS run's own estimate"))
# the legs the document has no table of: every seed's error within
# tests/test_examples.py's band for its model (the autocorrelated leg's
# thinned rows; its unthinned row is the caveat it prints: ln Z biased low)
STUDY_BANDS = {"importance": 0.15, "banana": 0.2, "autocorr": 0.2}


def study_document(path=STUDY_DOC):
    """docs/VALIDATION_STUDY.md's tables, cell for cell as printed: table
    name -> {row key: the cells after the key}.  A key is the row's number
    (or a tuple of its key columns); the nested table's input is the study
    module's name for it."""
    tables, rows = [], None
    with open(path) as fh:
        for line in fh:
            if not line.startswith("|"):
                rows = None
                continue
            cells = [c.strip().strip("*")
                     for c in line.strip().strip("|").split("|")]
            if rows is None:
                rows = []
                tables.append((cells, rows))
            elif set(cells[0]) != {"-"}:
                rows.append(cells)
    if len(tables) != len(STUDY_TABLES):
        raise AssertionError(f"{path}: {len(tables)} tables, expected "
                             f"{len(STUDY_TABLES)}")
    doc = {}
    for (name, fields, _), (header, rows) in zip(STUDY_TABLES, tables):
        if tuple(header[:len(fields)]) != fields:
            raise AssertionError(f"{path}: table {name} has header {header}")
        table = doc[name] = {}
        for cells in rows:
            key = [int(c) if f != "input" else
                   next(ours for ours, text in NESTED_INPUTS
                        if c.startswith(text))
                   for f, c in zip(fields, cells)]
            table[key[0] if len(key) == 1 else tuple(key)] = tuple(
                cells[len(fields):])
    return doc


def held_study_cells(doc, name, rows):
    """The printed cells of a documented table against the document's
    (``study_document``): (cells held, mismatches)."""
    fields, first = next((f, i) for n, f, i in STUDY_TABLES if n == name)
    held, bad = 0, []
    if len(rows) != len(doc[name]):
        bad.append({"table": name, "rows": len(rows),
                    "document_rows": len(doc[name])})
    for row in rows:
        key = tuple(row[f] for f in fields)
        key = key[0] if len(key) == 1 else key
        want = doc[name].get(key)
        if want is None:
            bad.append({"table": name, "row": row["cells"][:first],
                        "want": "no such row in the document"})
            continue
        got = row["cells"][first:first + len(want)]
        held += len(want)
        if got != want:
            bad.append({"table": name, "row": row["cells"][:first],
                        "got": got, "want": want})
    return held, bad


def study_phase(total, smi, trees):
    """9. The validation study as a user runs it, in this process
    (``validation_study.main`` with stdout captured), each run with the
    launch counts set to 0 just before it and read just after; then the
    port's ``compare_grids`` on phase 4c's trees.  ``trees``: label ->
    (the per-cell refine tree, the defaults' tree)."""
    import pandas as pd
    from mcevidence_tpu_torch import compare_grids, validation_study
    t_phase = time.perf_counter()
    doc = study_document()
    for argv in STUDY_RUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with Counted(f"validation study {' '.join(argv)}", total) as c, \
                contextlib.redirect_stdout(buf):
            tables = validation_study.main(list(argv))
        seconds = time.perf_counter() - t0
        c.require("knn_select_small_k")
        held, bad = 0, []
        for name in STUDY_DOCUMENTED[argv]:
            h, b = held_study_cells(doc, name, tables[name])
            held, bad = held + h, bad + b
        bands = {}
        for name, band in STUDY_BANDS.items():
            if name in tables:
                errs = [x for r in tables[name] if r.get("thin") != 1
                        for x in r.get("error", r["lnz"])]
                bands[name] = {"band": band, "max_abs_error":
                               float(np.max(np.abs(errs)))}
        unthinned = [x for r in tables.get("autocorr", ())
                     if r["thin"] == 1 for x in r["error"]]
        finite = all(np.all(np.isfinite(np.ravel(part)))
                     for rows in tables.values() for r in rows
                     for part in (r["lnz"].values()
                                  if isinstance(r["lnz"], dict)
                                  else [r["lnz"]]))
        ok = bool(finite and not bad and c.plain_on_card == 0
                  and all(b["max_abs_error"] <= b["band"]
                          for b in bands.values())
                  and all(x < 0 for x in unthinned))
        phase("study", run=" ".join(argv), seconds=seconds,
              tables={name: [r["cells"] for r in rows]
                      for name, rows in tables.items()},
              documented_cells_held=held, mismatches=bad, bands=bands,
              unthinned_errors=unthinned, launches=c.counts,
              plain_on_card=c.plain_on_card, gpu=smi, ok=ok)
        if not ok:
            raise AssertionError(f"validation study {argv}: finite {finite},"
                                 f" mismatches {bad}, bands {bands}, "
                                 f"unthinned {unthinned}, plain selection "
                                 f"on the card {c.plain_on_card}\n"
                                 f"{buf.getvalue()}")

    # the comparator of the golden regression on phase 4c's trees, then on
    # a copy with one AllChains cell moved by 1e-5
    def compare(ref, ours):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = compare_grids.main([ref, ours, "1e-6"])
        return rc, out.getvalue().strip()

    runs = {label: compare(*pair) for label, pair in trees.items()}
    ok = all(rc == 0 for rc, _ in runs.values())
    ref, ours = trees["AllChains"]
    with tempfile.TemporaryDirectory() as tmp:
        moved = shutil.copytree(ours, os.path.join(tmp, "moved"))
        csv = os.path.join(moved, "AllChains", "csv")
        path = os.path.join(csv, min(f for f in os.listdir(csv)
                                     if f.startswith("mce_")))
        df = pd.read_csv(path, index_col=0)
        df.iloc[0, df.columns.get_loc("AllChains")] += 1e-5
        df.to_csv(path)
        runs["AllChains, one cell moved by 1e-5"] = compare(ref, moved)
    ok = ok and runs["AllChains, one cell moved by 1e-5"][0] != 0
    phase("study_compare_grids", tol=1e-6,
          runs={label: {"rc": rc, "report": out}
                for label, (rc, out) in runs.items()}, ok=ok)
    if not ok:
        raise AssertionError(f"compare_grids: {runs}")
    phase("study_seconds", total_s=time.perf_counter() - t_phase, gpu=smi)


# phase 10: the envelope's command, the sizes refine is held to device at,
# the size device is held to the f64 oracle at (the oracle's f64 plain
# selection grows as N^2), and the rows of the sampled kernel cert
ENVELOPE_ARGS = ("20", "8")
ENVELOPE_POWERS = (17, 18, 19, 20)
ENVELOPE_ORACLE_N = 2 ** 17
ENVELOPE_REFINE_N = (2 ** 18, 2 ** 20, 1_000_000)
ENVELOPE_CERT_ROWS = 4096
ENVELOPE_CERT_NR = 1_000_000


def envelope_cert(name, x64, k, nr, sample, dev):
    """The small-k kernel's self selection of the first ``nr`` rows of
    ``x64`` (cast to f32; rows past ``nr`` in the allocation hold 1e8
    garbage) at the ``sample`` query rows, against an f64 brute-force kNN of
    those rows on the card, held to ``REL_TOL`` as the kernel cert holds a
    leg.  Returns the leg's (max_rel, max_abs)."""
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    alloc = torch.as_tensor(x64, dtype=torch.float32, device=dev)
    if nr < alloc.shape[0]:
        alloc[nr:] = 1e8
    kd2, kidx = kh.knn_select_small_k(alloc[:nr], alloc, k, self_mode=True,
                                      nr=nr)
    rows = torch.as_tensor(sample, device=dev)
    kd2, kidx = kd2[rows], kidx[rows]
    del alloc
    if not bool((kidx[:, 0] == rows).all()):
        raise AssertionError(f"{name}: self pin broken")
    ref = torch.as_tensor(x64[:nr], dtype=torch.float64, device=dev)
    query = ref[rows]
    # cross mode over every valid row: the query row itself comes first at
    # d2 = 0, as the kernel's self pin puts it
    pd2, pidx = kh.knn_select_torch(query, ref, k)
    res = check_selection(name, query, ref, kd2, kidx, pd2, pidx, False, nr)
    return report(name, k, len(sample), nr, *res, False,
                  emit=lambda r: phase("envelope_cert", **r))


def envelope_phase(total, smi, dev="cuda", args=ENVELOPE_ARGS,
                   powers=ENVELOPE_POWERS, oracle_n=ENVELOPE_ORACLE_N,
                   refine_n=ENVELOPE_REFINE_N, cert_rows=ENVELOPE_CERT_ROWS,
                   cert_nr=ENVELOPE_CERT_NR):
    """10. One card's N envelope: ``python -m mcevidence_tpu_torch.envelope
    20 8`` as a child process, every point held (fast within 3e-3 of
    device, no CUDA tensor on the plain selection; device within 1e-6 of
    the f64 oracle at ``oracle_n``); refine (``evidence_fn`` at its
    defaults) within 1e-6 of device at ``refine_n``; the small-k kernel
    timed at the largest point, and its selection of ``cert_rows`` sampled
    query rows against an f64 brute-force kNN of them, on all rows and with
    ``cert_nr`` valid rows in the allocation.  The arguments cut
    the phase for a rehearsal on a host without a card (``dev="cpu"``,
    ``Counted.require`` stubbed)."""
    from mcevidence_tpu_torch import envelope, evidence_fn
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    t_phase = time.perf_counter()
    rc, _, out, err, child_s = harness("envelope",
                                       [*args, "--device", dev])
    points = {}
    for line in out.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            points[rec["n"]] = rec
    missing = [2 ** p for p in powers if 2 ** p not in points]
    if rc != 0 or missing:
        raise AssertionError(f"envelope: exit {rc}, points missing "
                             f"{missing}\n{out[-3000:]}\n{err[-3000:]}")
    d = int(args[1])
    kmax = envelope.KMAX
    for n, rec in sorted(points.items()):
        ok = ("error" not in rec and rec["dlnz_fast_dev"] <= FAST_DLNZ_TOL
              and rec["launches"]["plain_on_cuda"] == 0)
        phase("envelope", **rec, tol=FAST_DLNZ_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"envelope N={n}: {rec}")
        for name in KERNELS:
            total[name] += rec["launches"][name]
    theta, lnl = envelope.chain(oracle_n, d)
    hold_to_oracle(f"envelope_device_vs_oracle N={oracle_n}",
                   points[oracle_n]["lnz_device"],
                   oracle_evidence(theta, lnl, kmax, dev=dev))
    for n in refine_n:
        theta, lnl = envelope.chain(n, d)
        with Counted(f"envelope refine N={n}", total) as c:
            t0 = time.perf_counter()
            got = evidence_fn(theta, lnl, kmax=kmax, device=dev)
            refine_s = time.perf_counter() - t0
            if n in points:
                want, device_s = points[n]["lnz_device"], None
            else:
                t0 = time.perf_counter()
                want = evidence_fn(theta, lnl, kmax=kmax,
                                   precision="device", device=dev)
                device_s = time.perf_counter() - t0
        c.require("knn_select_small_k")
        dlnz = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        ok = bool(np.all(np.isfinite(got)) and dlnz <= DLNZ_TOL
                  and c.plain_on_card == 0)
        phase("envelope_refine", n=n, refine_s=refine_s,
              device_s=device_s if device_s is not None
              else points[n]["device_s"],
              device_from="this process" if device_s is not None
              else "envelope", lnz_refine=np.asarray(got).tolist(),
              lnz_device=np.asarray(want).tolist(), max_abs_dlnz=dlnz,
              tol=DLNZ_TOL, plain_selection_on_card=c.plain_on_card,
              gpu=smi, ok=ok)
        if not ok:
            raise AssertionError(f"envelope refine N={n}: |dlnZ| {dlnz} > "
                                 f"{DLNZ_TOL} or the plain selection ran on "
                                 "the card")
    # the small-k kernel at the largest point, then its sampled f64 cert
    n = 2 ** max(powers)
    theta = envelope.chain(n, d)[0]
    x = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    kernel_row = self_row("knn_select_small_k", kh.knn_select_small_k, x,
                          kmax + 4, f"self N={n} d={d} k={kmax + 4} "
                          "(envelope)", plain=None, library=False, gpu=smi,
                          timer=cuda_ms if dev != "cpu" else host_ms)
    del x
    valid = min(n, cert_nr)
    sample = np.sort(np.random.default_rng(n).choice(valid, cert_rows,
                                                     replace=False))
    for nr in sorted({n, valid}, reverse=True):
        envelope_cert(f"small_k sampled N={n} nr={nr} d={d} k={kmax + 4}",
                      theta, kmax + 4, nr, sample, dev)
    phase("envelope_seconds", total_s=time.perf_counter() - t_phase,
          child_s=child_s, kernel_ms=kernel_row["ms"], gpu=smi)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mcevidence_tpu_torch import MCEvidence, cli, evidence_fn, planck
    from mcevidence_tpu_torch.ops import _build, knn_hopper as kh
    from mcevidence_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                   probe)

    # 1. probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = probe()
    smi = gpu_name_and_power_limit()
    phase("probe", **info,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    dev = torch.device("cuda")

    # 2. build: the default path's library alone (what a user's first call
    # waits for), then the others, one nvcc each, all started together; no
    # library is loaded here (phase 4a reads which ones the default path
    # loads)
    t0 = time.perf_counter()
    _build.build("knn_select")
    default_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    libraries = _build.build()
    others_s = time.perf_counter() - t0
    log = "".join(_build.build_logs[s] for s in sorted(_build.build_logs))
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
    phase("build", libraries={s: os.path.relpath(p, HERE)
                              for s, p in libraries.items()},
          max_registers=max(regs, default=None), spill_bytes=sum(spills),
          bodies=resource_table(log),
          sources=sorted(os.listdir(_build.CSRC)),
          default_library_s=default_s, other_libraries_s=others_s,
          nvcc_seconds_per_source=dict(_build.source_seconds),
          flags=" ".join(_build.NVCC_FLAGS))

    # 3. kernel vs plain on the card
    rng = np.random.default_rng(7)

    def cu(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    errs = {n: [] for n in KERNELS}
    small, large = kh.knn_select_small_k, kh.knn_select_large_k
    smalld = kh.knn_select_smalld
    x = cu(rng.normal(size=(65536, 8)))
    xd = rng.normal(size=(65536, 8))
    xd[1::97] = xd[0::97][: len(xd[1::97])]           # exact duplicates
    xd = cu(xd)
    garbage = rng.normal(size=(65536, 8))
    garbage[60000:] = 1e8
    garbage = cu(garbage)
    qx, rx = cu(rng.normal(size=(32768, 8))), cu(rng.normal(size=(32768, 8)))
    # the last field: the leg also holds the returned d2 (the fast legs:
    # centred inputs, as whitened chains are)
    legs_small = [
        ("self N=65536 d=8 k=9", x, x, 9, True, None, True),
        ("self duplicates k=9", xd, xd, 9, True, None, True),
        ("cross Nq=Nr=32768 d=8 k=9", qx, rx, 9, False, None, True),
        ("self nr=60000 garbage 1e8 k=9", garbage[:60000], garbage, 9,
         True, 60000, False),
        ("cross nr=60000 garbage 1e8 k=9", qx, garbage, 9, False, 60000,
         False),
        ("self d=20 k=9", cu(rng.normal(size=(16384, 20))), None, 9, True,
         None, False),
        ("self d=32 k=9", cu(rng.normal(size=(16384, 32))), None, 9, True,
         None, False),
        ("self k=1", x, x, 1, True, None, True),
        ("cross k=1", qx, rx, 1, False, None, True),
        ("self k=13", x, x, 13, True, None, True),
        ("cross k>nr", qx[:1000], rx, 9, False, 5, False),
    ]
    for name, q, r, k, self_mode, nr, ret in legs_small:
        r = q if r is None else r
        errs["knn_select_small_k"].append(
            compare("small_k " + name, small, q, r, k, self_mode, nr, ret))
    lat = cu(lattice_chain()[0])
    legs_large = [
        ("self N=65536 d=8 k=14", x, x, 14, True, None, True),
        ("self N=65536 d=8 k=20", x, x, 20, True, None, True),
        ("self N=65536 d=8 k=26", x, x, 26, True, None, True),
        ("self N=65536 d=8 k=44", x, x, 44, True, None, True),
        ("self duplicates k=26", xd, xd, 26, True, None, True),
        ("self lattice 64000 d=3 k=32 ties", lat, lat, 32, True, None,
         False),
        ("cross Nq=4096 Nr=300000 k=26", qx[:4096],
         cu(rng.normal(size=(300000, 8))), 26, False, None, True),
        ("self nr=60000 garbage 1e8 k=26", garbage[:60000], garbage, 26,
         True, 60000, False),
        ("cross k>nr", qx[:1000], rx, 26, False, 20, False),
        ("self d=32 k=44", cu(rng.normal(size=(8192, 32))), None, 44, True,
         None, False),
    ]
    for name, q, r, k, self_mode, nr, ret in legs_large:
        r = q if r is None else r
        errs["knn_select_large_k"].append(
            compare("large_k " + name, large, q, r, k, self_mode, nr, ret))

    # batched: B=4 members with heterogeneous counts; rows past each
    # member's count hold 1e8 garbage
    def members(counts, rows, d, dup=False):
        a = rng.normal(size=(len(counts), rows, d))
        if dup:
            a[:, 1::97] = a[:, 0::97][:, : a[:, 1::97].shape[1]]
        for b, n in enumerate(counts):
            a[b, n:] = 1e8
        return cu(a)

    n_self = [16384, 12000, 9000, 600]
    n_ref = [16384, 14000, 7000, 20]      # the last member: nr < k at k >= 26
    q8 = members(n_self, 16384, 8)
    r8 = members(n_ref, 16384, 8)
    legs_batched = []
    for k in (6, 9, 26, 106):
        legs_batched += [
            (f"self B=4 n=16384/12000/9000/600 d=8 k={k}", q8, q8, k, True,
             n_self, n_self),
            (f"cross B=4 nq=16384/12000/9000/600 nr=16384/14000/7000/20 "
             f"d=8 k={k}", q8, r8, k, False, n_ref, n_self)]
    qd = members(n_self, 16384, 8, dup=True)
    legs_batched += [
        ("self duplicates B=4 d=8 k=9", qd, qd, 9, True, n_self, n_self),
        ("self duplicates B=4 d=8 k=26", qd, qd, 26, True, n_self, n_self),
        ("self member nr=5 < k B=4 d=8 k=9", q8, q8, 9, True,
         [16384, 12000, 9000, 5], [16384, 12000, 9000, 5])]
    for d in (6, 7, 16):
        qq = members(n_self, 16384, d)
        legs_batched.append((f"self B=4 d={d} k=9", qq, qq, 9, True, n_self,
                             n_self))
    for name, q, r, k, self_mode, nr, nq in legs_batched:
        errs["knn_select_batched"].append(
            compare_batched("batched " + name, q, r, k, self_mode, nr, nq))
    # the grid's fast program consumes the batched kernel's returned d2:
    # centred members without garbage, as its whitened chains are
    qc = cu(np.stack([bench_chain(16384, 8, seed=s)[0] for s in range(4)])
            - np.arange(1.0, 9.0))
    nb = [16384, 12000, 9000, 600]
    for k in (5, 20):
        errs["knn_select_batched"].append(compare_batched(
            f"batched self centred B=4 d=8 k={k} (fast grid)", qc, qc, k,
            True, nb, nb, returned=True))

    # smalld: the sweep over the widths and k the smalld paths ask for, at
    # N=16384 (self) and Nq=4096/Nr=16384 (cross), then the edge cases
    for d in (1, 3, 6, 7, 8, 16):
        xs = cu(rng.normal(size=(16384, d)))
        qs = cu(rng.normal(size=(4096, d)))
        for k in (1, 9, 13, 14, 26, 44, 106):
            errs["knn_select_smalld"].append(compare(
                f"smalld self N=16384 d={d} k={k}", smalld, xs, xs, k, True,
                returned=True))
            errs["knn_select_smalld"].append(compare(
                f"smalld cross Nq=4096 Nr=16384 d={d} k={k}", smalld, qs,
                xs, k, False, returned=True))
    g7 = rng.normal(size=(65536, 7))
    g7[60000:] = 1e8
    g7 = cu(g7)
    d3 = rng.normal(size=(65536, 3))
    d3[1::97] = d3[0::97][: len(d3[1::97])]
    d3 = cu(d3)
    legs_smalld = [
        ("self N=65536 d=8 k=9", x, x, 9, True, None),
        ("self N=65536 d=8 k=44", x, x, 44, True, None),
        ("self lattice 64000 d=3 k=32 ties", lat, lat, 32, True, None),
        ("self nr=60000 garbage 1e8 d=7 k=9", g7[:60000], g7, 9, True,
         60000),
        ("cross nr=60000 garbage 1e8 d=7 k=44", g7[:4096], g7, 44, False,
         60000),
        ("self duplicates d=3 k=9", d3, d3, 9, True, None),
        ("self duplicates d=3 k=26", d3, d3, 26, True, None),
        ("cross k>nr d=7 k=9", g7[:1000], g7, 9, False, 5),
        ("cross k>nr d=7 k=44", g7[:1000], g7, 44, False, 20),
    ]
    for name, q, r, k, self_mode, nr in legs_smalld:
        errs["knn_select_smalld"].append(
            compare("smalld " + name, smalld, q, r, k, self_mode, nr))
    for d in (3, 6, 8, 16):
        qq = members(n_self, 16384, d)
        rr = members(n_ref, 16384, d)
        for k in (6, 9, 26, 106):
            errs["knn_select_smalld"].append(compare_batched(
                f"smalld batched self B=4 n=16384/12000/9000/600 d={d} "
                f"k={k}", qq, qq, k, True, n_self, n_self, kernel=smalld))
            errs["knn_select_smalld"].append(compare_batched(
                f"smalld batched cross B=4 nr=16384/14000/7000/20 d={d} "
                f"k={k}", qq, rr, k, False, n_ref, n_self, kernel=smalld))
    qd3 = members(n_self, 16384, 3, dup=True)
    errs["knn_select_smalld"].append(compare_batched(
        "smalld batched self duplicates B=4 d=3 k=9", qd3, qd3, 9, True,
        n_self, n_self, kernel=smalld))
    # packed (K6/K7 at 11 low bits, K1 forced at 12) against the plain
    # version with the same truncation, 2-D and batched
    for lb in (11, 12):
        packed = functools.partial(kh.knn_select_packed, low_bits=lb)
        legs_packed = [
            ("self N=65536 d=8 k=9", x, x, 9, True, None, True),
            ("self duplicates k=9", xd, xd, 9, True, None, True),
            ("cross Nq=Nr=32768 d=8 k=9", qx, rx, 9, False, None, True),
            ("self nr=60000 garbage 1e8 k=9", garbage[:60000], garbage, 9,
             True, 60000, False),
            ("cross nr=60000 garbage 1e8 k=26", qx[:8192], garbage, 26,
             False, 60000, False),
            ("cross k>nr k=9", qx[:1000], rx, 9, False, 5, False),
            ("cross k>nr k=44", qx[:1000], rx, 44, False, 20, False),
            ("self k=1", x, x, 1, True, None, True),
            ("self k=13", x, x, 13, True, None, True),
            ("self k=14", x, x, 14, True, None, True),
            ("self N=65536 d=8 k=44", x, x, 44, True, None, True),
            ("self N=16384 d=8 k=106", x[:16384], x[:16384], 106, True,
             None, True),
            ("self duplicates k=26", xd, xd, 26, True, None, True),
            ("self lattice 64000 d=3 k=32 ties", lat, lat, 32, True, None,
             False),
            ("self d=6 k=9", cu(rng.normal(size=(16384, 6))), None, 9, True,
             None, True),
            ("self d=16 k=9", cu(rng.normal(size=(16384, 16))), None, 9,
             True, None, True),
            ("self d=32 k=9", cu(rng.normal(size=(16384, 32))), None, 9,
             True, None, False),
            ("self d=32 k=44", cu(rng.normal(size=(8192, 32))), None, 44,
             True, None, False),
        ]
        for name, q, r, k, self_mode, nr, ret in legs_packed:
            r = q if r is None else r
            errs["knn_select_packed"].append(compare(
                f"packed low_bits={lb} {name}", packed, q, r, k, self_mode,
                nr, ret, low_bits=lb))
        qq = members(n_self, 16384, 6)
        legs_packed_b = [("self B=4 d=6 k=9", qq, qq, 9, True, n_self,
                          n_self),
                         ("self duplicates B=4 d=8 k=9", qd, qd, 9, True,
                          n_self, n_self)]
        for k in (6, 26, 106):
            legs_packed_b += [
                (f"self B=4 n=16384/12000/9000/600 d=8 k={k}", q8, q8, k,
                 True, n_self, n_self),
                (f"cross B=4 nr=16384/14000/7000/20 d=8 k={k}", q8, r8, k,
                 False, n_ref, n_self)]
        for name, q, r, k, self_mode, nr, nq in legs_packed_b:
            errs["knn_select_packed"].append(compare_batched(
                f"packed low_bits={lb} batched {name}", q, r, k, self_mode,
                nr, nq, kernel=packed, low_bits=lb))
    # the prologue study (S1), K1's function at 12 low bits: N not a
    # multiple of 128, so the sentinel rows are in play
    xp = cu(rng.normal(size=(65536 - 37, 8)))
    for variant in ("B", "BC"):
        prologue = functools.partial(kh.knn_select_prologue, variant=variant)
        for name, q, r, k, nr in [
                ("self N=65499 d=8 k=1", xp, xp, 1, None),
                ("self N=65499 d=8 k=5", xp, xp, 5, None),
                ("self N=65499 d=8 k=13", xp, xp, 13, None),
                ("self nr=60000 garbage 1e8 k=5", garbage[:60000], garbage,
                 5, 60000),
                ("self N=1000 d=20 k=5", cu(rng.normal(size=(1000, 20))),
                 None, 5, None)]:
            r = q if r is None else r
            errs["knn_select_prologue"].append(compare(
                f"prologue {variant} {name}", prologue, q, r, k, True, nr,
                nr is None, low_bits=12,
                plain=kh.knn_select_prologue_torch))
    # the selection bodies' edges: 5993 rows is no multiple of a tile (128
    # small-k rows, 512 or 256 large-k rows) or of a block's query rows (256
    # small-k, 16 large-k), 100 rows are under one tile; the batched form
    # adds members whose query counts cut a block, and a member under one
    # tile
    def edges(name, k, self_mode, q, r, nr, ties=False):
        n_q = q.shape[0]
        wname = "knn_select_small_k" if k < 14 else "knn_select_large_k"
        forms = [(wname, getattr(kh, wname), q, r), ("knn_select_smalld",
                                                     smalld, q[:, :5], r[:, :5])]
        for wname, fn, qq, rr in forms:
            qq, rr = qq.contiguous(), rr.contiguous()
            if self_mode:
                rr = qq
            errs[wname].append(compare(f"{wname} edge {name}", fn, qq, rr, k,
                                       self_mode, nr, returned=True))
            if ties and tie_order_broken(
                    fn(qq, rr, k, self_mode=self_mode, nr=nr)[1], self_mode,
                    nr if nr is not None else rr.shape[0]):
                raise AssertionError(f"{wname} edge {name}: tie order")
        q3 = torch.stack([q, q.flip(0), q])
        r3 = q3 if self_mode else torch.stack([r, r.flip(0), r])
        n_r = r.shape[0] if nr is None else nr
        nq3 = [n_q, n_q - 7, 3] if self_mode else [n_q, 1001, 3]
        nr3 = nq3 if self_mode else [n_r, n_r - 13, min(n_r, 100)]
        errs["knn_select_batched"].append(compare_batched(
            f"batched edge {name} nq={nq3} nr={nr3}", q3, r3, k, self_mode,
            nr3, nq3, returned=True))
        if ties:
            kidx = kh.knn_select_batched(q3, r3, k, self_mode=self_mode,
                                         nr=nr3, nq=nq3)[1]
            for b in range(3):
                if tie_order_broken(kidx[b, :nq3[b]], self_mode, nr3[b]):
                    raise AssertionError(f"batched edge {name}: member {b} "
                                         "tie order")

    xe = cu(rng.normal(size=(5993, 8)))
    re_ = cu(rng.normal(size=(5993, 8)))
    one = cu(np.full((5993, 8), 0.5))
    for self_mode in (True, False):
        mode = "self" if self_mode else "cross"
        for k in (31, 32, 33, 63, 64, 65, 128, 129, 255, 256):
            edges(f"{mode} N=5993 k={k}", k, self_mode, xe, re_, None)
        for k in (9, 33, 129):
            edges(f"{mode} one point N=5993 k={k}", k, self_mode, one, one,
                  None, ties=True)
            edges(f"{mode} nr=100 under one tile k={k}", k, self_mode,
                  xe[:100] if self_mode else xe, re_, 100)
    # the wide kernel (k > 256 or d > 64): 2-D and batched, self and cross,
    # exact and at 11 and 12 low bits; nr under one of its 256-row tiles and
    # not a multiple of one; one-point rows in the exact tie order; and
    # where the two bodies also apply, their bits exactly
    wide = kh.knn_select_wide
    xw = x[:16384]
    legs_wide = [("self N=16384 d=8 k=257", xw, None, 257, None),
                 ("self N=16384 d=8 k=512", xw, None, 512, None),
                 ("self N=8192 d=8 k=1024", x[:8192], None, 1024, None),
                 ("cross Nq=4096 Nr=16384 d=8 k=512", qx[:4096], xw, 512,
                  None),
                 ("self nr=100 k=300", x[:100], x[:4096], 300, 100),
                 ("cross nr=5993 k=300", qx[:2000], xw, 300, 5993),
                 ("self nr=60000 garbage 1e8 k=264", garbage[:60000],
                  garbage, 264, 60000),
                 # route B's lists in the global workspace, its query rows
                 # launched in chunks
                 ("self N=12000 d=8 k=9000 workspace", x[:12000], None, 9000,
                  None)]
    for d in (65, 100, 128):
        xd_ = cu(rng.normal(size=(8192, d)))
        qd_ = cu(rng.normal(size=(2048, d)))
        for k in (9, 44):
            legs_wide += [(f"self N=8192 d={d} k={k}", xd_, None, k, None),
                          (f"cross Nq=2048 Nr=8192 d={d} k={k}", qd_, xd_, k,
                           None)]
    for lb in (0, 11, 12):
        fn = functools.partial(wide, low_bits=lb)
        for name, q, r, k, nr in legs_wide:
            if lb and "d=8" not in name and "nr=" not in name:
                continue
            self_mode = name.startswith("self")
            r = q if r is None else r
            errs["knn_select_wide"].append(compare(
                f"wide low_bits={lb} {name}", fn, q, r, k, self_mode, nr,
                "garbage" not in name, low_bits=lb))
    onew = cu(np.full((1000, 70), 0.5))
    for self_mode in (True, False):
        for k in (9, 300):
            kidx = wide(onew, onew, k, self_mode=self_mode)[1]
            errs["knn_select_wide"].append(compare(
                f"wide one point N=1000 d=70 k={k} self={self_mode}", wide,
                onew, onew, k, self_mode, returned=True))
            if tie_order_broken(kidx, self_mode, 1000):
                raise AssertionError(f"wide one point k={k}: tie order")
    q3w = cu(rng.normal(size=(3, 3000, 8)))
    for k in (264, 600):
        for self_mode, nr3, nq3 in ((True, [3000, 2100, 40],
                                     [3000, 2100, 40]),
                                    (False, [3000, 1000, 300],
                                     [2999, 3000, 7])):
            errs["knn_select_wide"].append(compare_batched(
                f"wide batched {'self' if self_mode else 'cross'} d=8 k={k} "
                f"nr={nr3} nq={nq3}", q3w, q3w, k, self_mode, nr3, nq3,
                kernel=wide, returned=True))
    qb65 = cu(rng.normal(size=(2, 2048, 65)))
    errs["knn_select_wide"].append(compare_batched(
        "wide batched self d=65 k=9 nr=[2048, 1500]", qb65, qb65, 9, True,
        [2048, 1500], [2048, 1500], kernel=wide, returned=True))
    for k in (9, 44, 200, 256):
        same = all(torch.equal(a, b) for a, b in zip(
            wide(xw, xw, k, self_mode=True),
            kh.knn_select_cuda(xw, xw, k, self_mode=True)))
        phase("kernel_vs_body", leg=f"wide vs the two bodies N=16384 d=8 "
              f"k={k}", identical=same, ok=same)
        if not same:
            raise AssertionError(f"wide k={k}: not the bodies' bits")
    # the warp queue's edges (512 and 1024 keys a row; route B past 1024
    # kept keys and for truncated keys), batched with heterogeneous counts
    # (a member whose query rows cut a block, one with fewer reference rows
    # than k), self and cross
    for d in (3, 8, 32, 64):
        qe3 = cu(rng.normal(size=(3, 1200, d)))
        re3 = cu(rng.normal(size=(3, 1300, d)))
        for k in (257, 511, 512, 513, 1023, 1024, 1025):
            for self_mode, nr3, nq3 in ((True, [1200, 1037, 600],
                                         [1200, 1037, 600]),
                                        (False, [1300, 1037, 600],
                                         [1200, 333, 17])):
                for lb in (0, 11, 12) if d in (8, 64) else (0,):
                    route = kh.wide_plan(d, k - self_mode, lb).route
                    errs["knn_select_wide"].append(compare_batched(
                        f"wide edge route {route} "
                        f"{'self' if self_mode else 'cross'} B=3 d={d} "
                        f"k={k} nr={nr3} nq={nq3}", qe3,
                        qe3 if self_mode else re3, k, self_mode, nr3, nq3,
                        kernel=functools.partial(wide, low_bits=lb),
                        returned=True, low_bits=lb))
    # where both routes apply (exact keys, d <= 64, keep <= 1024) they
    # return the same bits
    for name, q, r, k in [
            ("self N=16384 d=8 k=300", xw, None, 300),
            ("self N=8192 d=8 k=1024", x[:8192], None, 1024),
            ("cross Nq=4096 Nr=16384 d=8 k=512", qx[:4096], xw, 512),
            ("self N=8192 d=64 k=700", cu(rng.normal(size=(8192, 64))), None,
             700)]:
        self_mode = r is None
        r = q if r is None else r
        same = all(torch.equal(a, b) for a, b in zip(
            wide(q, r, k, self_mode=self_mode),
            kh._launch_wide(q, r, k, self_mode, None, None, 0, True,
                            route="B")))
        phase("kernel_vs_route", leg=f"wide route A vs route B {name}",
              identical=same, ok=same)
        if not same:
            raise AssertionError(f"wide {name}: the routes differ")
    del xd, garbage, qx, rx, q8, r8, qd, qq, rr, qc, xs, qs, g7, d3, qd3, xp
    del xe, re_, one, xw, xd_, qd_, onew, q3w, qb65, qe3, re3
    torch.cuda.empty_cache()

    total = {n: 0 for n in KERNELS}

    # 4a. refine precision, the main path of the first slice
    theta, lnl = bench_chain(65536, 8, seed=0)
    half = theta.shape[0] // 2
    lat_theta, lat_lnl = lattice_chain()
    with Counted("refine evidence_fn + CLI", total) as c:
        t0 = time.perf_counter()
        auto = evidence_fn(theta, lnl, kmax=5, device="cuda")
        auto_s = time.perf_counter() - t0
        cross = evidence_fn(theta[:half], lnl[:half], samples2=theta[half:],
                            kmax=5, device="cuda")
        retry = evidence_fn(lat_theta, lat_lnl, kmax=2, device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            root = write_toy_root(tmp, np.random.default_rng(3))
            cli_auto = run_cli([root, "-k", "3", "-vb", "0"])
            cli_cross = run_cli([root, "-k", "3", "--cross", "--seed", "1",
                                 "-vb", "0"])
    c.require("knn_select_small_k", "knn_select_large_k")
    oracles = {"auto": oracle_evidence(theta, lnl, 5),
               "cross": oracle_evidence(theta[:half], lnl[:half], 5,
                                        theta2=theta[half:]),
               "retry": oracle_evidence(lat_theta, lat_lnl, 2),
               "auto20": oracle_evidence(theta, lnl, 20)}
    hold_to_oracle("main_auto", auto, oracles["auto"])
    hold_to_oracle("main_cross", cross, oracles["cross"])
    hold_to_oracle("main_retry", retry, oracles["retry"])
    phase("cli", auto=cli_auto, cross=cli_cross, ok=True)
    # which libraries the default refine path loads: a fresh process (this
    # one loaded every library in phase 3) runs it at its defaults
    proc = subprocess.run([sys.executable, "-c", DEFAULT_PATH_LIBRARIES],
                          capture_output=True, text=True, cwd=HERE,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"default path libraries: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    ok = loaded["loaded"] == ["knn_select"]
    phase("libraries_after_default_refine", **loaded, ok=ok)
    if not ok:
        raise AssertionError(f"the default refine path loaded {loaded}")

    # 4b. device precision
    with Counted("device evidence_fn", total) as c:
        t0 = time.perf_counter()
        dev_auto = evidence_fn(theta, lnl, kmax=5, precision="device",
                               device="cuda")
        dev_auto_s = time.perf_counter() - t0
        dev_cross = evidence_fn(theta[:half], lnl[:half],
                                samples2=theta[half:], kmax=5,
                                precision="device", device="cuda")
        dev_retry = evidence_fn(lat_theta, lat_lnl, kmax=2,
                                precision="device", device="cuda")
    c.require("knn_select_small_k", "knn_select_large_k")
    hold_to_oracle("device_auto", dev_auto, oracles["auto"])
    hold_to_oracle("device_cross", dev_cross, oracles["cross"])
    hold_to_oracle("device_retry", dev_retry, oracles["retry"])

    # 4d. fast precision
    with Counted("fast evidence_fn + MCEvidence + CLI", total) as c:
        t0 = time.perf_counter()
        fast_auto = evidence_fn(theta, lnl, kmax=5, precision="fast",
                                device="cuda")
        fast_auto_s = time.perf_counter() - t0
        fast_cross = evidence_fn(theta[:half], lnl[:half],
                                 samples2=theta[half:], kmax=5,
                                 precision="fast", device="cuda")
        fast_20 = evidence_fn(theta, lnl, kmax=20, precision="fast",
                              device="cuda")
        fused = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=5,
                           verbose=0, precision="fast",
                           device="cuda").evidence()
        with tempfile.TemporaryDirectory() as tmp:
            root = write_toy_root(tmp, np.random.default_rng(3))
            cli_fast = run_cli([root, "-k", "3", "-vb", "0", "--precision",
                                "fast"])
    c.require("knn_select_small_k", "knn_select_large_k")
    hold_to_oracle("fast_auto", fast_auto, oracles["auto"], FAST_DLNZ_TOL)
    hold_to_oracle("fast_cross", fast_cross, oracles["cross"],
                   FAST_DLNZ_TOL)
    hold_to_oracle("fast_kmax20", fast_20, oracles["auto20"], FAST_DLNZ_TOL)
    hold_to_oracle("fast_mcevidence_fused", fused, oracles["auto"],
                   FAST_DLNZ_TOL)
    hold_to_oracle("fast_cli", np.array(cli_fast), np.array(cli_auto),
                   FAST_DLNZ_TOL)
    # the whitening's products run in f64: TF32 cannot change them
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=5,
                          verbose=0, precision="fast",
                          device="cuda").evidence()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    same = bool(np.array_equal(tf32, fused))
    phase("fast_tf32_on", lnz=tf32.tolist(), tf32_off=fused.tolist(),
          unchanged=same, ok=same)
    if not same:
        raise AssertionError("fast: TF32 changed the result")
    hold_to_oracle("fast_tf32_on_vs_oracle", tf32, oracles["auto"],
                   FAST_DLNZ_TOL)

    # 4e. the pallas_smalld engine
    with Counted("pallas_smalld refine + device evidence_fn", total) as c:
        sd_auto = evidence_fn(theta, lnl, kmax=5, engine="pallas_smalld",
                              device="cuda")
        sd_cross = evidence_fn(theta[:half], lnl[:half],
                               samples2=theta[half:], kmax=5,
                               engine="pallas_smalld", device="cuda")
        sd_retry = evidence_fn(lat_theta, lat_lnl, kmax=2,
                               engine="pallas_smalld", device="cuda")
        sd_dev = evidence_fn(theta, lnl, kmax=5, precision="device",
                             engine="pallas_smalld", device="cuda")
    c.require("knn_select_smalld")
    hold_to_oracle("smalld_refine_auto", sd_auto, oracles["auto"])
    hold_to_oracle("smalld_refine_cross", sd_cross, oracles["cross"])
    hold_to_oracle("smalld_refine_retry", sd_retry, oracles["retry"])
    hold_to_oracle("smalld_device_auto", sd_dev, oracles["auto"])

    # 4f. the forced engines: each precision with the wrapper the engine
    # map (ops/knn.py:selector) names for its path
    forced = {
        "pallas_packed": {"refine": "knn_select_packed",
                          "device": "knn_select_packed",
                          "fast": "knn_select_packed"},
        "pallas_packed2": {"refine": "knn_select_packed",
                           "device": "knn_select_packed",
                           "fast": "knn_select_packed"},
        "pallas_binned": {"refine": "knn_select_large_k",
                          "device": "knn_select_packed",
                          "fast": "knn_select_large_k"},
    }
    for engine, legs in forced.items():
        for precision, kernel in legs.items():
            with Counted(f"{engine} {precision} evidence_fn", total) as c:
                got = evidence_fn(theta, lnl, kmax=5, precision=precision,
                                  engine=engine, device="cuda")
                if precision == "fast":
                    fused_f = MCEvidence(
                        {"samples": theta, "loglikes": lnl}, kmax=5,
                        verbose=0, precision="fast", engine=engine,
                        device="cuda").evidence()
            c.require(kernel)
            tol = FAST_DLNZ_TOL if precision == "fast" else DLNZ_TOL
            hold_to_oracle(f"{engine}_{precision}_auto", got,
                           oracles["auto"], tol)
            if precision == "fast":
                hold_to_oracle(f"{engine}_fast_mcevidence_fused", fused_f,
                               oracles["auto"], tol)
    # the lattice's ties make the refine guard re-select through the
    # large-k body (k = 4*6+8 = 32) under 11-bit truncation
    with Counted("pallas_packed refine lattice retry", total) as c:
        pk_retry = evidence_fn(lat_theta, lat_lnl, kmax=2,
                               engine="pallas_packed", device="cuda")
    if c.counts["knn_select_packed"] < 2:
        raise AssertionError("pallas_packed lattice: the guard did not "
                             "re-select")
    hold_to_oracle("pallas_packed_refine_retry", pk_retry, oracles["retry"])

    # 4c/4d/4e/4f. the grid driver: each run against the per-cell refine
    # tables of its mode
    datasets = planck.DATASETS[:2]
    stages = StageLog()
    grid_log = logging.getLogger("mcevidence_tpu_torch.planck")
    grid_log.addHandler(stages)
    grid_log.setLevel(logging.INFO)      # the stage lines, whatever -v says
    grid_times = {}
    # phase 9 compares the per-cell refine trees with the defaults' trees
    kept = tempfile.TemporaryDirectory(prefix="chip_smoke_trees_")
    trees = {}
    with tempfile.TemporaryDirectory() as tmp:
        grid = os.path.join(tmp, "grid")
        t0 = time.perf_counter()
        write_grid(grid, datasets, np.random.default_rng(20261016))
        phase("grid_written", datasets=datasets, cells=[
            {"model": m, "ndim": d, "rows": n, "chains": GRID_NCHAINS}
            for m, d, n in GRID_MODELS], seconds=time.perf_counter() - t0)
        # pandas (the driver's tables) is imported once, on the first grid
        # call: time it here, outside the grid's wall times
        t0 = time.perf_counter()
        import pandas  # noqa: F401
        phase("grid_setup", import_pandas_s=time.perf_counter() - t0)
        base = ["--rootdir", grid, "-v", "0", "-nd", str(len(datasets))]
        modes = {"AllChains": ("AllChains", []),
                 "-nc 4": ("SingleChains", ["-nc", "4"])}
        refs = {}
        for label, (mode, extra) in modes.items():
            ref_out = os.path.join(tmp, "ref_" + mode)
            t0 = time.perf_counter()
            rc = planck.main(base + ["-o", ref_out, "--no-batch-cells",
                                     "--precision", "refine"] + extra)
            if rc != 0:
                raise AssertionError(f"grid {label} refine: exit {rc}")
            grid_times[label] = {"refine_per_cell_wall_s":
                                 time.perf_counter() - t0}
            refs[label] = read_tables(ref_out, mode, datasets)
        runs = [
            ("AllChains", "defaults", [], "knn_select_small_k", DLNZ_TOL),
            ("-nc 4", "defaults", [], "knn_select_batched", DLNZ_TOL),
            ("AllChains", "fast", ["--precision", "fast"],
             "knn_select_batched", FAST_GRID_TOL),
            ("-nc 4", "fast", ["--precision", "fast"], "knn_select_batched",
             FAST_GRID_TOL),
            ("-nc 4", "pallas_packed", ["--engine", "pallas_packed"],
             "knn_select_packed", DLNZ_TOL),
            ("AllChains", "pallas_packed", ["--engine", "pallas_packed"],
             "knn_select_packed", DLNZ_TOL),
            ("-nc 4", "pallas_smalld", ["--engine", "pallas_smalld"],
             "knn_select_smalld", DLNZ_TOL),
        ]
        for label, variant, flags, kernel, tol in runs:
            mode, extra = modes[label]
            out = os.path.join(tmp, f"out_{mode}_{variant}")
            n_stage = len(stages.stages)
            with Counted(f"grid {label} {variant}", total) as c:
                t0 = time.perf_counter()
                rc = planck.main(base + ["-o", out] + extra + flags)
                wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"grid {label} {variant}: exit {rc}")
            c.require(kernel)
            grid_times[label][variant] = dict(
                wall_s=wall, stages=stages.stages[n_stage:])
            worst = tables_gap(f"{label} {variant}",
                               read_tables(out, mode, datasets), refs[label],
                               datasets)
            ok = worst <= tol
            phase("grid", mode=label, variant=variant, datasets=datasets,
                  max_abs_dlnz_vs_refine_per_cell=worst, tol=tol,
                  launches=c.counts, ok=ok)
            if not ok:
                raise AssertionError(f"grid {label} {variant}: |dlnZ| "
                                     f"{worst} > {tol}")
        for label, (mode, _) in modes.items():
            trees[label] = tuple(
                shutil.copytree(os.path.join(tmp, src),
                                os.path.join(kept.name, src))
                for src in ("ref_" + mode, f"out_{mode}_defaults"))
    grid_log.removeHandler(stages)

    # 4g. the JSON-lines service (a child process, and in-process), --json
    # and the model comparison, against MCEvidence on the same roots
    from mcevidence_tpu_torch import serve
    from mcevidence_tpu_torch.chains.reader import load_chains
    from mcevidence_tpu_torch.priors.params_info import get_prior_volume
    with tempfile.TemporaryDirectory() as tmp:
        roots = []
        for i, sub in enumerate(("a", "b")):
            os.makedirs(os.path.join(tmp, sub))
            roots.append(write_toy_root(os.path.join(tmp, sub),
                                        np.random.default_rng(3 + i)))
        root = roots[0]
        pv, ndim = get_prior_volume(root, cosmo=True)
        reference = MCEvidence(load_chains(root), priorvolume=pv, ndim=ndim,
                               kmax=3, verbose=0, device="cuda").evidence()
        reqs = [{"id": "refine", "root": root, "kmax": 3},
                {"id": "device", "root": root, "kmax": 3,
                 "precision": "device"},
                {"id": "fast", "root": root, "kmax": 3, "precision": "fast"},
                {"id": "pallas_packed", "root": root, "kmax": 3,
                 "engine": "pallas_packed"},
                {"id": "bad", "root": root, "kmax": 3, "bogus": 1}]
        lines = "".join(json.dumps(r) + "\n" for r in reqs)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mcevidence_tpu_torch.serve", "--warmup",
             "65536,8", "--workers", "2"], input=lines, capture_output=True,
            text=True, cwd=HERE, timeout=600)
        service_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"service: exit {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
        resps = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.strip()]
        with Counted("service in-process, workers=2", total) as c:
            out = io.StringIO()
            rc = serve.serve(io.StringIO(lines), out, workers=2,
                             device="cuda")
        c.require("knn_select_small_k", "knn_select_packed")
        inproc = [json.loads(ln) for ln in out.getvalue().splitlines()]
        for label, got in (("child", resps), ("in-process", inproc)):
            if [r.get("id") for r in got] != [r["id"] for r in reqs]:
                raise AssertionError(f"service {label}: responses out of "
                                     f"order: {got}")
            if got[-1]["ok"] or not all(r["ok"] for r in got[:-1]):
                raise AssertionError(f"service {label}: {got}")
            for r in got[:-1]:
                hold_to_oracle(f"service_{label}_{r['id']}", r["lnz"],
                               reference, FAST_DLNZ_TOL if r["id"] == "fast"
                               else DLNZ_TOL)
        if rc != 0:
            raise AssertionError(f"service in-process: rc {rc}")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            cli_rc = cli.main([root, "-k", "3", "--json"])
        one = json.loads(buf.getvalue().strip().splitlines()[-1])
        same = (cli_rc == 0 and set(one) == set(resps[0])
                and np.allclose(one["lnz"], resps[0]["lnz"], rtol=0,
                                atol=1e-9))
        phase("cli_json", fields=sorted(one), lnz=one["lnz"],
              service_lnz=resps[0]["lnz"], ok=same)
        if not same:
            raise AssertionError(f"--json: {one} vs {resps[0]}")
        proc = subprocess.run(
            [sys.executable, "-m", "mcevidence_tpu_torch.compare",
             f"A={roots[0]}", f"B={roots[1]}", "-k", "3", "--json"],
            capture_output=True, text=True, cwd=HERE, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"compare: exit {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        gaps = []
        for row, r in zip(rows, roots):
            want = MCEvidence(r, kmax=3, priorvolume=row["PriorVol"],
                              ndim=row["ndim"], verbose=0,
                              device="cuda").evidence()
            gaps.append(float(np.max(np.abs(np.asarray(row["lnE"]) - want))))
        ok = len(rows) == 2 and max(gaps) <= 1e-9
        phase("compare", models=[r["model"] for r in rows],
              lnE=[r["lnE"] for r in rows], max_abs_dlnz_vs_mcevidence=gaps,
              ok=ok)
        if not ok:
            raise AssertionError(f"compare rows: {rows}, gaps {gaps}")
    phase("service", requests=[r["id"] for r in reqs],
          child_wall_s=service_s, ok=True)

    # 4h. past the two bodies' limits (k > 256 or d > 64) the card answers
    # with the wide kernel, never the plain selection: the refine guard's
    # retry at kmax = 60 (4 (60 + 4) + 8 = 264 candidates), fast at
    # kmax = 300, and a 65-parameter chain in each precision (device takes
    # the host refine path past 16 columns, as in JAX)
    wide_theta, wide_lnl = bench_chain(16384, 65, seed=65)
    wide_oracles = {60: oracle_evidence(theta, lnl, 60),
                    300: oracle_evidence(theta, lnl, 300),
                    "d65": oracle_evidence(wide_theta, wide_lnl, 5)}
    with Counted("past the limits: kmax 60 / 300, d = 65", total) as c:
        t0 = time.perf_counter()
        k60 = evidence_fn(theta, lnl, kmax=60, device="cuda")
        k60_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        k300 = evidence_fn(theta, lnl, kmax=300, precision="fast",
                           device="cuda")
        k300_s = time.perf_counter() - t0
        d65 = {prec: evidence_fn(wide_theta, wide_lnl, kmax=5,
                                 precision=prec, device="cuda")
               for prec in ("refine", "device", "fast")}
    c.require("knn_select_wide", "knn_select_large_k")
    if c.plain_on_card:
        raise AssertionError(f"the plain selection ran on the card "
                             f"{c.plain_on_card} times")
    hold_to_oracle("wide_refine_kmax60", k60, wide_oracles[60])
    hold_to_oracle("wide_fast_kmax300", k300, wide_oracles[300],
                   FAST_DLNZ_TOL)
    for prec, got in d65.items():
        hold_to_oracle(f"wide_d65_{prec}", got, wide_oracles["d65"],
                       FAST_DLNZ_TOL if prec == "fast" else DLNZ_TOL)
    phase("wide_paths", refine_kmax60_s=k60_s, fast_kmax300_s=k300_s,
          plain_selection_on_card=c.plain_on_card, gpu=smi, ok=True)

    phase("launches", path="main paths, total", **total)
    for name, n in total.items():
        # the prologue study is no user's path: it has its own, in phase 5
        if n == 0 and name != "knn_select_prologue":
            raise AssertionError(f"{name} was never launched by the main "
                                 "paths")

    # 5. times, kernel beside plain, at the main paths' shapes: rows of
    # kernel_bench (CUDA events; the bound of the TPU kernel's work; the
    # library pair on each kernel's first row, which the kernels line
    # quotes, and on every other shape PERF.md's kernel table quotes)
    lat_t = cu(lat_theta - lat_theta.mean(0))
    xs = {d: cu(bench_chain(65536, d, seed=d)[0] - np.arange(1.0, d + 1.0))
          for d in (3, 6, 7, 8)}
    times = {}

    def keep(rows):
        for r in rows:
            times.setdefault(r["kernel"], r)
        return rows

    def row(name, fn, q, k, shape, plain=kh.knn_select_torch, **kw):
        kw.setdefault("library", name not in times)
        return keep([self_row(name, fn, q, k, shape, plain=plain, gpu=smi,
                              **kw)])[0]

    row("knn_select_small_k", small, x, 9, "self N=65536 d=8 k=9")
    row("knn_select_large_k", large, x, 44,
        "self N=65536 d=8 k=44 (retry of kmax=5)")
    row("knn_select_large_k", large, lat_t, 32,
        "self N=64000 d=3 k=32 (lattice retry)", library=True)
    row("knn_select_large_k", large, x, 14, "self N=65536 d=8 k=14")
    row("knn_select_large_k", large, x, 20,
        "self N=65536 d=8 k=20 (fast, kmax=20)", library=True)
    row("knn_select_large_k", large, x, 26, "self N=65536 d=8 k=26")
    for d in (8, 7, 6, 3):
        keep(smalld_study(xs[d], ks=(9, 44), library=d == 8, gpu=smi))
    row("knn_select_smalld", smalld, lat_t, 32,
        "self N=64000 d=3 k=32 (smalld, lattice retry)")
    # the wide kernel at the shapes of phase 4h: the refine retry of
    # kmax = 60, fast at kmax = 300, the d = 65 chain's first pass
    x65 = cu(wide_theta - wide_theta.mean(0))
    wide_rows = [row("knn_select_wide", kh.knn_select_wide, x, k, shape,
                     library=True)
                 for k, shape in ((264, "self N=65536 d=8 k=264 (refine "
                                        "retry of kmax=60)"),
                                  (300, "self N=65536 d=8 k=300 (fast, "
                                        "kmax=300)"))]
    row("knn_select_large_k", large, x, 256,
        "self N=65536 d=8 k=256 (beside wide)")
    row("knn_select_wide", kh.knn_select_wide, x65, 9,
        "self N=16384 d=65 k=9 (d=65 chain, first pass)", library=True)
    # the packed selections (K6 at 11 low bits, K1 forced at 12) beside the
    # exact kernels at the refine path's first pass and retry
    keep(packed2_study(x, ks=(9, 44), low_bits=(11, 12), gpu=smi))
    # the bodies' sweep over k and d at N=65536 (the plain version, whose
    # time hardly moves with k, is timed above)
    xs[32] = cu(rng.normal(size=(65536, 32)))
    for d in (3, 8, 32):
        for name, fn, ks in (("knn_select_small_k", small, (5, 9, 13)),
                             ("knn_select_large_k", large,
                              (14, 20, 26, 44, 106, 256))):
            for k in ks:
                row(name, fn, xs[d], k, f"self N=65536 d={d} k={k} (sweep)",
                    plain=None, library=False)
    del xs[32]
    # the wide kernel across k and d, each shape with its route, and route B
    # beside route A where both apply (the routing rule's crossover)
    xw_ = {d: cu(rng.normal(size=(65536, d))) for d in (3, 32, 64)}
    xw_.update({d: cu(rng.normal(size=(16384, d))) for d in (65, 100, 128)})
    for q, d, k in ([(x, 8, k) for k in (264, 300, 512, 1024, 2048)]
                    + [(xw_[d], d, 300) for d in (3, 32, 64)]
                    + [(xw_[d], d, k) for d in (65, 100, 128)
                       for k in (9, 44)]):
        n = q.shape[0]
        route = kh.wide_plan(d, k - 1).route
        extra = {}
        if route == "A":
            extra["route_b_ms"] = cuda_ms(lambda: kh._launch_wide(
                q, q, k, True, None, None, 0, True, route="B"))
        row("knn_select_wide", kh.knn_select_wide, q, k,
            f"self N={n} d={d} k={k} (sweep)", plain=None, library=False,
            route=route, **extra)
    del xw_
    # the yardstick of the wide kernel's rows above, on a line of its own:
    # one library pair, never called by the port
    for r in wide_rows:
        phase("time", kernel="knn_select_wide",
              shape=r["shape"].split(" (")[0] + " (library pair)",
              library_pair_ms=r["library_ms"], library_pair=LIBRARY_PAIR,
              gpu=smi)
    # the prologue study's own path (scripts/bench_prologue.py's main): a
    # gate against K1's function without the cuts, then each variant timed
    # at its operating points (:196-210) beside that function and the
    # small-k kernel the default dispatch runs
    study = {n: 0 for n in KERNELS}
    with Counted("prologue study", study) as c:
        prologue_gate(x)
        keep(prologue_study(x, ks=(5, 1), gpu=smi))
    c.require("knn_select_prologue")
    # the study's own kernel; its K1 and small-k launches only time them
    total["knn_select_prologue"] = study["knn_select_prologue"]
    qb = cu(np.stack([bench_chain(16384, 8, seed=s)[0] for s in range(4)])
            - np.arange(1.0, 9.0))
    nb = [16384] * 4
    for k in (6, 26):
        shape = f"self B=4 Nq=Nr=16384 d=8 k={k}"
        row("knn_select_batched", kh.knn_select_batched, qb, k, shape,
            plain=kh.knn_select_torch_batched, nr=nb, library=True)
        # the small-d kernel's batched form (K9) on the same batch
        row("knn_select_smalld", smalld, qb, k, shape + " (batched form)",
            plain=kh.knn_select_torch_batched, nr=nb, library=True)
        # the packed selection's batched form (K7) on the same batch
        row("knn_select_packed", kh.knn_select_packed, qb, k,
            shape + " low_bits=11 (K7)", plain=functools.partial(
                kh.knn_select_torch_batched, low_bits=11), nr=nb,
            library=True)
    walls = {}
    for precision in ("refine", "device", "fast", "fast", "device",
                      "refine"):
        t0 = time.perf_counter()
        evidence_fn(theta, lnl, kmax=5, precision=precision, device="cuda")
        walls.setdefault(precision, []).append(time.perf_counter() - t0)
    phase("time_evidence_fn", shape="auto N=65536 d=8 kmax=5, no ingest",
          first_refine_s=auto_s, first_device_s=dev_auto_s,
          first_fast_s=fast_auto_s, refine_s=walls["refine"],
          device_s=walls["device"], fast_s=walls["fast"], gpu=smi)
    walls = {}
    for precision in ("refine", "device", "fast", "fast", "device",
                      "refine"):
        t0 = time.perf_counter()
        evidence_fn(theta, lnl, kmax=5, precision=precision,
                    engine="pallas_packed", device="cuda")
        walls.setdefault(precision, []).append(time.perf_counter() - t0)
    phase("time_evidence_fn", engine="pallas_packed",
          shape="auto N=65536 d=8 kmax=5, no ingest",
          refine_s=walls["refine"], device_s=walls["device"],
          fast_s=walls["fast"], gpu=smi)
    phase("time_service", shape="toy root 2 x 3000 rows d=3 kmax=3, after "
          "--warmup 65536,8, --workers 2",
          wall_s={r["id"]: r.get("wall_s") for r in resps},
          child_process_s=service_s, gpu=smi)
    fused_s = []
    for _ in range(3):
        mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=5,
                         verbose=0, precision="fast", device="cuda")
        mce.evidence()
        fused_s.append(mce.timings["fused_s"])
    phase("time_fast_fused", shape="MCEvidence fast auto N=65536 d=8 "
          "kmax=5", fused_s=fused_s, gpu=smi)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=5,
                     verbose=0, device="cuda")
    stage_runs = []
    for _ in range(3):
        mce.evidence()
        stage_runs.append(dict(mce.timings))
    phase("time_stages", shape="MCEvidence auto N=65536 d=8 kmax=5",
          **{key: statistics.median(t[key] for t in stage_runs)
             for key in ("whiten_s", "knn_s", "estimator_s")},
          ingest_s=mce.timings["ingest_s"], gpu=smi)
    for label, t in grid_times.items():
        phase("time_grid", mode=label,
              shape="2 datasets x 4 models, d=6/7/7/8, 24000-64000 rows "
                    "per cell in 4 chains", **t, gpu=smi)

    # 6. the ring: 2 and 4 ranks of one gloo group, processes on the one
    # card, each answer held to the one-card answer of phases 4a-4d
    ring_phase(total, smi, theta, lnl, {
        "refine": auto, "device": dev_auto, "fast": fast_auto,
        "cross": cross})

    # 7. the validation path: the examples' chains through the kernels,
    # NUTS on the card, the examples' CLI and the profiler trace
    validation_phase(total, smi, theta, lnl)

    # 8. the benchmark harnesses (bench, bench_serve, bench_grid) as a user
    # runs them
    bench_phase(total, smi, refs=refs)

    # 9. the validation study at the document's seed counts, and the grid
    # comparator on phase 4c's trees
    study_phase(total, smi, trees)
    kept.cleanup()

    # 10. one card's N envelope, 2^17 to 2^20 rows, and refine at 2^18,
    # 2^20 and 1,000,000 rows
    envelope_phase(total, smi)

    # each kernel's body (the __global__ function) is in knn_common.cuh; the
    # source beside it instantiates it and holds the C entry point
    csrc = "mcevidence_tpu_torch/csrc/"
    body = csrc + "knn_common.cuh"
    pallas = "mcevidence_tpu/ops/knn_pallas.py"
    kernels = [
        {"name": "knn_select_small_k", "entry": csrc + "knn_select.cu",
         "replaces": f"{pallas}:275", "also_replaces": f"{pallas}:151"},
        {"name": "knn_select_large_k", "entry": csrc + "knn_select.cu",
         "replaces": f"{pallas}:892",
         "also_replaces": f"{pallas}:749 {pallas}:151"},
        {"name": "knn_select_batched", "entry": csrc + "knn_select.cu",
         "replaces": f"{pallas}:371"},
        {"name": "knn_select_smalld", "entry": csrc + "knn_smalld.cu",
         "replaces": f"{pallas}:546", "also_replaces": f"{pallas}:634"},
        {"name": "knn_select_packed", "entry": csrc + "knn_packed.cu",
         "replaces": f"{pallas}:258",
         "also_replaces": f"{pallas}:398 {pallas}:275"},
        {"name": "knn_select_prologue", "entry": csrc + "knn_packed.cu",
         "replaces": "scripts/bench_prologue.py:65"},
        # its own bodies, the warp-queue body built from the large-k body's
        # parts on knn_padded.cuh's rows: the cover of K2/K4/K6's shapes
        # past the two bodies
        {"name": "knn_select_wide", "entry": csrc + "knn_wide.cu",
         "body": csrc + "knn_wide.cu", "headers": [csrc + "knn_padded.cuh"],
         "replaces": f"{pallas}:892",
         "also_replaces": f"{pallas}:151 {pallas}:258"},
    ]
    for kern in kernels:
        src = kern.pop("body", body)
        kern.update(route="cuda", source=src,
                    sources=sorted({src, body, kern.pop("entry"),
                                    *kern.pop("headers", [])}))
        nm = kern["name"]
        t = times[nm]
        # no single PyTorch call selects k nearest neighbours: the library
        # time is the pair torch.cdist then torch.topk on the same inputs
        kern.update(launches=total[nm],
                    max_abs_err=max(a for _, a in errs[nm]),
                    max_rel_d2_err=max(r for r, _ in errs[nm]),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    bound_flops=FLOPS_TEXT[nm], shape=t["shape"],
                    library_ms=t["library_ms"], library=LIBRARY_PAIR)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
