"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
non-zero.  Without a CUDA device, or without the package beside it, it
fails before printing any result.

1. probe: torch/CUDA versions, the card, nvcc; TF32 switched off.
2. build: nvcc builds ``mcevidence_tpu_torch/csrc/*.cu`` for sm_90a, one
   process per source, all started together; each source's compile time.
3. kernel vs plain: each kernel against its plain version on the same CUDA
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
4. the main paths through the user's entry points, each with the launch
   counts set to 0 just before it and read just after:
   a. refine precision: ``evidence_fn`` auto, cross, a lattice whose ties
      force the refine guard's retry, and the CLI, against an f64 oracle
      (whitening and the estimator written out here, fed by an f64
      brute-force kNN on the card) at |dlnZ| <= 1e-6; both unbatched
      kernels must launch;
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
5. times: each kernel against its plain version at the main paths' shapes
   (the small-d kernel beside the small-k and large-k kernels at d = 3, 6,
   7, 8), each kernel's bound (``bound``: the least operations of the TPU
   kernel it replaces at the card's FP32 peak, or its bytes at the memory
   rate), ``evidence_fn`` refine, device and fast wall times, and
   the grid's per-dataset stage times, each printed with the card's name
   and power limit.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import logging
import math
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

REL_TOL = 2.0 ** -10          # the kernel-cert criterion
D2_REL_TOL = 2.0 ** -18       # returned f32 d2 vs the plain version's
DLNZ_TOL = 1e-6               # refine vs f64 oracle, tests/test_evidence.py
FAST_DLNZ_TOL = 3e-3          # fast vs refine, tests/test_evidence.py:169
FAST_GRID_TOL = 5e-3          # fast grid vs refine, tests/test_planck.py:161
FP32_PEAK = 67e12             # H100 SXM f32 outside the tensor cores, 700 W
HBM_RATE = 3.35e12            # H100 SXM HBM3 bytes/s
HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("knn_select_small_k", "knn_select_large_k", "knn_select_batched",
           "knn_select_smalld")


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


def oracle_evidence(theta, lnl, kmax, theta2=None):
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
    sq = torch.as_tensor(s, dtype=torch.float64, device="cuda")
    rq = sq if not cross else torch.as_tensor(r, dtype=torch.float64,
                                              device="cuda")
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


def f64_d2_at(query, ref, idx):
    """f64 squared distances at the returned indices, -1 -> +inf."""
    safe = idx.clamp(min=0).long()
    diff = query.double()[:, None, :] - ref.double()[safe]
    d2 = (diff * diff).sum(-1)
    return torch.where(idx < 0, torch.full_like(d2, math.inf), d2)


def returned_d2_rel(kd2, pd2):
    """Largest relative gap between the kernel's returned f32 d2 and the
    plain version's, both sorted per row; zero distances must match."""
    k = torch.sort(kd2.double(), dim=1).values
    p = torch.sort(pd2.double(), dim=1).values
    fin = torch.isfinite(p)
    if bool(((p[fin] == 0) != (k[fin] == 0)).any()):
        raise AssertionError("returned d2: zero distances differ")
    pos = fin & (p > 0)
    if not bool(pos.any()):
        return 0.0
    return float(((k[pos] - p[pos]).abs() / p[pos]).max())


def check_selection(name, query, ref, kd2, kidx, pd2, pidx, self_mode,
                    nr=None):
    """One selection against the plain version's; returns (max_rel,
    max_abs, returned_rel) of the d2."""
    if kd2.shape != pd2.shape:
        raise AssertionError(f"{name}: shape {tuple(kd2.shape)} vs "
                             f"{tuple(pd2.shape)}")
    if not bool(((kidx < 0) == (pidx < 0)).all()) or not bool(
            (torch.isinf(kd2) == torch.isinf(pd2)).all()):
        raise AssertionError(f"{name}: absent slots differ")
    if self_mode:
        rows = torch.arange(query.shape[0], device=kidx.device)
        if not bool((kidx[:, 0] == rows).all()) or bool(kd2[:, 0].any()):
            raise AssertionError(f"{name}: self pin broken")
    if nr is not None and bool((kidx >= nr).any()):
        raise AssertionError(f"{name}: selected a row at or past nr={nr}")
    # the f64 d2 of the raw rows at the kernel's indices against the plain
    # version's f32 d2 of centred rows.  Centring in f32 moves each
    # coordinate difference by at most e = 2^-23 (max|x| + max|mu|), so a d2
    # by at most 2 sqrt(d d2) e + d e^2: that stays below REL_TOL of any d2
    # above floor = 5 d e^2 / REL_TOL^2, and below REL_TOL * floor under it.
    # The mean is taken here in f64 over the valid rows, apart from the
    # port's, so garbage reaching the port's mean shows as a gap.
    valid = ref[:ref.shape[0] if nr is None else nr].double()
    scale = float(query.double().abs().max()) if query.numel() else 0.0
    if valid.numel():
        scale = max(scale, float(valid.abs().max())) + float(
            valid.mean(0).abs().max())
    e = 2.0 ** -23 * scale
    floor = 5.0 * query.shape[-1] * e * e / REL_TOL ** 2
    got = torch.sort(f64_d2_at(query, ref, kidx), dim=1).values
    want = torch.sort(pd2.double(), dim=1).values
    fin = torch.isfinite(want)
    num = (got[fin] - want[fin]).abs()
    rel = abs_err = 0.0
    if num.numel():
        rel = float((num / want[fin].clamp(min=max(floor, 1e-30))).max())
        abs_err = float((kd2.double()[fin] - want[fin]).abs().max())
    return rel, abs_err, returned_d2_rel(kd2, pd2)


def report(name, k, nq, nr, rel, abs_err, d2_rel, returned):
    """``returned``: the leg also holds the returned d2 to D2_REL_TOL."""
    ok = rel <= REL_TOL and (not returned or d2_rel <= D2_REL_TOL)
    phase("kernel_vs_plain", leg=name, k=k, nq=nq, nr=nr, max_rel_d2_err=rel,
          max_abs_d2_err=abs_err, returned_d2_rel_err=d2_rel,
          returned_d2_checked=returned, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: max_rel_d2_err {rel} > {REL_TOL} or "
                             f"returned d2 {d2_rel} > {D2_REL_TOL}")
    return rel, abs_err


def compare(name, kernel, query, ref, k, self_mode, nr=None,
            returned=False):
    """One unbatched kernel-vs-plain leg on CUDA tensors."""
    from mcevidence_tpu_torch.ops.knn_hopper import knn_select_torch
    kd2, kidx = kernel(query, ref, k, self_mode=self_mode, nr=nr)
    pd2, pidx = knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr)
    torch.cuda.synchronize()
    res = check_selection(name, query, ref, kd2, kidx, pd2, pidx, self_mode,
                          nr)
    return report(name, k, query.shape[0],
                  ref.shape[0] if nr is None else nr, *res, returned)


def compare_batched(name, query, ref, k, self_mode, nr, nq, kernel=None,
                    returned=False):
    """One batched kernel-vs-plain leg: member b's first nq[b] rows are
    checked like an unbatched leg against its first nr[b] reference rows;
    its padded query rows must come back absent."""
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    kernel = kernel or kh.knn_select_batched
    kd2, kidx = kernel(query, ref, k, self_mode=self_mode, nr=nr, nq=nq)
    pd2, pidx = kh.knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr,
                                            nq=nq)
    torch.cuda.synchronize()
    rel = abs_err = d2_rel = 0.0
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        if not bool((kidx[b, n_q:] == -1).all()) or not bool(
                torch.isinf(kd2[b, n_q:]).all()):
            raise AssertionError(f"{name}: member {b} padded rows not "
                                 "absent")
        r_b, a_b, d_b = check_selection(
            f"{name} member {b}", query[b, :n_q], ref[b], kd2[b, :n_q],
            kidx[b, :n_q], pd2[b, :n_q], pidx[b, :n_q], self_mode, n_r)
        rel, abs_err, d2_rel = max(rel, r_b), max(abs_err, a_b), max(d2_rel,
                                                                     d_b)
    return report(name, k, list(nq), list(nr), rel, abs_err, d2_rel,
                  returned)


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
    """Collects the grid driver's per-dataset stage lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages = []

    def emit(self, record):
        if record.getMessage().startswith("dataset stages"):
            ingest, parse_wait, device = record.args
            self.stages.append({"ingest_s": ingest, "parse_wait_s":
                                parse_wait, "device_fetch_s": device})


def run_cli(argv):
    import contextlib
    import io

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
    """Launch counts of one main path: set to 0 on entry, read on exit."""

    def __init__(self, name, total):
        self.name, self.total = name, total

    def __enter__(self):
        from mcevidence_tpu_torch.ops import knn_hopper as kh
        self.kh = kh
        kh.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.counts = {n: getattr(self.kh, n).launches for n in KERNELS}
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
              "knn_select_smalld": "3*d a pair (K8, K9)"}


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mcevidence_tpu_torch import MCEvidence, evidence_fn, planck
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

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = [int(n) for n in re.findall(r"Used (\d+) registers",
                                       _build.build_log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                         _build.build_log)]
    phase("build", library=os.path.relpath(lib_path, HERE),
          max_registers=max(regs, default=None), spill_bytes=sum(spills),
          sources=sorted(os.listdir(_build.CSRC)), seconds=build_s,
          nvcc_seconds=_build.build_seconds,
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
    del xd, garbage, qx, rx, q8, r8, qd, qq, rr, qc, xs, qs, g7, d3, qd3
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

    # 4c/4d/4e. the grid driver: each run against the per-cell refine
    # tables of its mode
    datasets = planck.DATASETS[:2]
    stages = StageLog()
    grid_log = logging.getLogger("mcevidence_tpu_torch.planck")
    grid_log.addHandler(stages)
    grid_log.setLevel(logging.INFO)      # the stage lines, whatever -v says
    grid_times = {}
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
    grid_log.removeHandler(stages)
    phase("launches", path="main paths, total", **total)
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched by the main "
                                 "paths")

    # 5. times, kernel beside plain, at the main paths' shapes
    lat_t = cu(lat_theta - lat_theta.mean(0))
    xs = {d: cu(bench_chain(65536, d, seed=d)[0] - np.arange(1.0, d + 1.0))
          for d in (3, 6, 7, 8)}
    timed = [("knn_select_small_k", small, x, 8, 9, "self N=65536 d=8 k=9"),
             ("knn_select_large_k", large, x, 8, 44,
              "self N=65536 d=8 k=44 (retry of kmax=5)"),
             ("knn_select_large_k", large, lat_t, 3, 32,
              "self N=64000 d=3 k=32 (lattice retry)"),
             ("knn_select_large_k", large, x, 8, 14,
              "self N=65536 d=8 k=14"),
             ("knn_select_large_k", large, x, 8, 20,
              "self N=65536 d=8 k=20 (fast, kmax=20)"),
             ("knn_select_large_k", large, x, 8, 26,
              "self N=65536 d=8 k=26")]
    for d in (8, 7, 6, 3):
        for k in (9, 44):
            timed.append(("knn_select_smalld", smalld, xs[d], d, k,
                          f"self N=65536 d={d} k={k} (smalld)"))
            timed.append(("knn_select_small_k" if k < 14
                          else "knn_select_large_k",
                          small if k < 14 else large, xs[d], d, k,
                          f"self N=65536 d={d} k={k} (beside smalld)"))
    timed.append(("knn_select_smalld", smalld, lat_t, 3, 32,
                  "self N=64000 d=3 k=32 (smalld, lattice retry)"))
    times = {}
    for name, fn, q, d, k, shape in timed:
        ms = cuda_ms(lambda: fn(q, q, k, self_mode=True))
        plain_ms = cuda_ms(lambda: kh.knn_select_torch(q, q, k,
                                                       self_mode=True))
        pairs = float(q.shape[0]) * q.shape[0]
        b_ms, b_by = bound(name, q.shape[0], d, k)
        phase("time", kernel=name, shape=shape, ms=ms, plain_ms=plain_ms,
              bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
              pairs_per_s=pairs / (ms * 1e-3),
              plain_pairs_per_s=pairs / (plain_ms * 1e-3), gpu=smi)
        times.setdefault(name, (ms, plain_ms, b_ms, b_by))
    qb = cu(np.stack([bench_chain(16384, 8, seed=s)[0] for s in range(4)])
            - np.arange(1.0, 9.0))
    nb = [16384] * 4
    for k in (6, 26):
        ms = cuda_ms(lambda: kh.knn_select_batched(qb, qb, k, self_mode=True,
                                                   nr=nb, nq=nb))
        plain_ms = cuda_ms(lambda: kh.knn_select_torch_batched(
            qb, qb, k, self_mode=True, nr=nb, nq=nb))
        pairs = 4.0 * 16384 * 16384
        b_ms, b_by = bound("knn_select_batched", 16384, 8, k, batch=4)
        phase("time", kernel="knn_select_batched",
              shape=f"self B=4 Nq=Nr=16384 d=8 k={k}", ms=ms,
              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
              share_of_bound=b_ms / ms, pairs_per_s=pairs / (ms * 1e-3),
              plain_pairs_per_s=pairs / (plain_ms * 1e-3), gpu=smi)
        times.setdefault("knn_select_batched", (ms, plain_ms, b_ms, b_by))
        # the small-d kernel's batched form (K9) on the same batch
        sd_ms = cuda_ms(lambda: smalld(qb, qb, k, self_mode=True, nr=nb,
                                       nq=nb))
        b_ms, b_by = bound("knn_select_smalld", 16384, 8, k, batch=4)
        phase("time", kernel="knn_select_smalld",
              shape=f"self B=4 Nq=Nr=16384 d=8 k={k} (batched form)",
              ms=sd_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
              share_of_bound=b_ms / sd_ms, pairs_per_s=pairs / (sd_ms * 1e-3),
              plain_pairs_per_s=pairs / (plain_ms * 1e-3), gpu=smi)
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

    src = "mcevidence_tpu_torch/csrc/knn_select.cu"
    pallas = "mcevidence_tpu/ops/knn_pallas.py"
    kernels = [
        {"name": "knn_select_small_k", "route": "cuda", "source": src,
         "replaces": f"{pallas}:275", "also_replaces": f"{pallas}:151"},
        {"name": "knn_select_large_k", "route": "cuda", "source": src,
         "replaces": f"{pallas}:892",
         "also_replaces": f"{pallas}:749 {pallas}:151"},
        {"name": "knn_select_batched", "route": "cuda", "source": src,
         "replaces": f"{pallas}:371"},
        {"name": "knn_select_smalld", "route": "cuda",
         "source": "mcevidence_tpu_torch/csrc/knn_smalld.cu",
         "replaces": f"{pallas}:546", "also_replaces": f"{pallas}:634"},
    ]
    for kern in kernels:
        nm = kern["name"]
        ms, plain_ms, b_ms, b_by = times[nm]
        # no single PyTorch call selects k nearest neighbours
        kern.update(launches=total[nm],
                    max_abs_err=max(a for _, a in errs[nm]),
                    max_rel_d2_err=max(r for r, _ in errs[nm]),
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, bound_flops=FLOPS_TEXT[nm],
                    library_ms=None)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
