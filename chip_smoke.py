"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
non-zero.  Without a CUDA device, or without the package beside it, it
fails before printing any result.

1. probe: torch/CUDA versions, the card, nvcc; TF32 switched off.
2. build: nvcc builds ``mcevidence_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernel vs plain: each kernel against its plain version on the same CUDA
   tensors: ``knn_select_small_k`` and ``knn_select_large_k`` against
   ``knn_select_torch``, ``knn_select_batched`` against
   ``knn_select_torch_batched`` member by member (heterogeneous per-member
   counts, garbage rows past them, duplicates, members with fewer rows than
   k, d = 6..16, k = 6..106).  Criterion (scripts/tpu_kernel_cert.py:
   40-68): the d2 recomputed in f64 at the kernel's indices, sorted, within
   2^-10 relative of the plain version's sorted d2; absent slots and the
   self pin equal; nothing selected at or past a member's count.
4. the main paths through the user's entry points, each with the launch
   counts set to 0 just before it and read just after, and each held to
   |dlnZ| <= 1e-6:
   a. refine precision: ``evidence_fn`` auto, cross, a lattice whose ties
      force the refine guard's retry, and the CLI, against an f64 oracle
      (whitening and the estimator written out here, fed by an f64
      brute-force kNN on the card); both unbatched kernels must launch;
   b. device precision: ``evidence_fn(precision="device")`` auto, cross and
      the lattice retry against the same oracle; both must launch;
   c. the Planck grid driver at its defaults on a synthetic Planck-shaped
      grid written here, in AllChains mode (the small-k kernel must launch)
      and with ``-nc 4`` (the batched kernel must launch), each table held
      to the driver's ``--no-batch-cells --precision refine`` table.
5. times: each kernel against its plain version at the main path's shapes,
   ``evidence_fn`` refine and device wall times, and the grid's per-dataset
   stage times, each printed with the card's name and power limit.

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
DLNZ_TOL = 1e-6               # refine vs f64 oracle, tests/test_evidence.py
HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("knn_select_small_k", "knn_select_large_k", "knn_select_batched")


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


def check_selection(name, query, ref, kd2, kidx, pd2, pidx, self_mode,
                    nr=None):
    """One selection against the plain version's; returns (max_rel,
    max_abs) of the d2."""
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
    got = torch.sort(f64_d2_at(query, ref, kidx), dim=1).values
    want = torch.sort(pd2.double(), dim=1).values
    fin = torch.isfinite(want)
    num = (got[fin] - want[fin]).abs()
    rel = abs_err = 0.0
    if num.numel():
        rel = float((num / want[fin].clamp(min=1e-30)).max())
        abs_err = float((kd2.double()[fin] - want[fin]).abs().max())
    return rel, abs_err


def report(name, k, nq, nr, rel, abs_err):
    ok = rel <= REL_TOL
    phase("kernel_vs_plain", leg=name, k=k, nq=nq, nr=nr, max_rel_d2_err=rel,
          max_abs_d2_err=abs_err, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: max_rel_d2_err {rel} > {REL_TOL}")
    return rel, abs_err


def compare(name, kernel, query, ref, k, self_mode, nr=None):
    """One unbatched kernel-vs-plain leg on CUDA tensors."""
    from mcevidence_tpu_torch.ops.knn_hopper import knn_select_torch
    kd2, kidx = kernel(query, ref, k, self_mode=self_mode, nr=nr)
    pd2, pidx = knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr)
    torch.cuda.synchronize()
    rel, abs_err = check_selection(name, query, ref, kd2, kidx, pd2, pidx,
                                   self_mode, nr)
    return report(name, k, query.shape[0],
                  ref.shape[0] if nr is None else nr, rel, abs_err)


def compare_batched(name, query, ref, k, self_mode, nr, nq):
    """One batched kernel-vs-plain leg: member b's first nq[b] rows are
    checked like an unbatched leg against its first nr[b] reference rows;
    its padded query rows must come back absent."""
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    kd2, kidx = kh.knn_select_batched(query, ref, k, self_mode=self_mode,
                                      nr=nr, nq=nq)
    pd2, pidx = kh.knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr,
                                            nq=nq)
    torch.cuda.synchronize()
    rel = abs_err = 0.0
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        if not bool((kidx[b, n_q:] == -1).all()) or not bool(
                torch.isinf(kd2[b, n_q:]).all()):
            raise AssertionError(f"{name}: member {b} padded rows not "
                                 "absent")
        r_b, a_b = check_selection(f"{name} member {b}", query[b, :n_q],
                                   ref[b], kd2[b, :n_q], kidx[b, :n_q],
                                   pd2[b, :n_q], pidx[b, :n_q], self_mode,
                                   n_r)
        rel, abs_err = max(rel, r_b), max(abs_err, a_b)
    return report(name, k, list(nq), list(nr), rel, abs_err)


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


def hold_to_oracle(name, got, want):
    dlnz = float(np.max(np.abs(got - want)))
    ok = bool(got.shape == want.shape and np.all(np.isfinite(got))
              and dlnz <= DLNZ_TOL)
    phase(name, lnz=got.tolist(), oracle=want.tolist(), max_abs_dlnz=dlnz,
          tol=DLNZ_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: |dlnZ| {dlnz} > {DLNZ_TOL}")


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
          nvcc_seconds=_build.build_seconds, flags=" ".join(_build.NVCC_FLAGS))

    # 3. kernel vs plain on the card
    rng = np.random.default_rng(7)

    def cu(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    errs = {n: [] for n in KERNELS}
    small, large = kh.knn_select_small_k, kh.knn_select_large_k
    x = cu(rng.normal(size=(65536, 8)))
    xd = rng.normal(size=(65536, 8))
    xd[1::97] = xd[0::97][: len(xd[1::97])]           # exact duplicates
    xd = cu(xd)
    garbage = rng.normal(size=(65536, 8))
    garbage[60000:] = 1e8
    garbage = cu(garbage)
    qx, rx = cu(rng.normal(size=(32768, 8))), cu(rng.normal(size=(32768, 8)))
    legs_small = [
        ("self N=65536 d=8 k=9", x, x, 9, True, None),
        ("self duplicates k=9", xd, xd, 9, True, None),
        ("cross Nq=Nr=32768 d=8 k=9", qx, rx, 9, False, None),
        ("self nr=60000 garbage 1e8 k=9", garbage[:60000], garbage, 9,
         True, 60000),
        ("cross nr=60000 garbage 1e8 k=9", qx, garbage, 9, False, 60000),
        ("self d=20 k=9", cu(rng.normal(size=(16384, 20))), None, 9, True,
         None),
        ("self d=32 k=9", cu(rng.normal(size=(16384, 32))), None, 9, True,
         None),
        ("self k=1", x, x, 1, True, None),
        ("cross k=1", qx, rx, 1, False, None),
        ("self k=13", x, x, 13, True, None),
        ("cross k>nr", qx[:1000], rx, 9, False, 5),
    ]
    for name, q, r, k, self_mode, nr in legs_small:
        r = q if r is None else r
        errs["knn_select_small_k"].append(
            compare("small_k " + name, small, q, r, k, self_mode, nr))
    lat = cu(lattice_chain()[0])
    legs_large = [
        ("self N=65536 d=8 k=14", x, x, 14, True, None),
        ("self N=65536 d=8 k=26", x, x, 26, True, None),
        ("self N=65536 d=8 k=44", x, x, 44, True, None),
        ("self duplicates k=26", xd, xd, 26, True, None),
        ("self lattice 64000 d=3 k=32 ties", lat, lat, 32, True, None),
        ("cross Nq=4096 Nr=300000 k=26", qx[:4096],
         cu(rng.normal(size=(300000, 8))), 26, False, None),
        ("self nr=60000 garbage 1e8 k=26", garbage[:60000], garbage, 26,
         True, 60000),
        ("cross k>nr", qx[:1000], rx, 26, False, 20),
        ("self d=32 k=44", cu(rng.normal(size=(8192, 32))), None, 44, True,
         None),
    ]
    for name, q, r, k, self_mode, nr in legs_large:
        r = q if r is None else r
        errs["knn_select_large_k"].append(
            compare("large_k " + name, large, q, r, k, self_mode, nr))

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
    del xd, garbage, qx, rx, lat, q8, r8, qd, qq
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
               "retry": oracle_evidence(lat_theta, lat_lnl, 2)}
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

    # 4c. the grid driver at its defaults against its per-cell refine
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
        for label, mode, extra, kernel in (
                ("AllChains", "AllChains", [], "knn_select_small_k"),
                ("-nc 4", "SingleChains", ["-nc", "4"],
                 "knn_select_batched")):
            out = os.path.join(tmp, "out_" + mode)
            ref_out = os.path.join(tmp, "ref_" + mode)
            n_stage = len(stages.stages)
            with Counted(f"grid {label} defaults", total) as c:
                t0 = time.perf_counter()
                rc = planck.main(base + ["-o", out] + extra)
                wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"grid {label}: exit {rc}")
            c.require(kernel)
            grid_times[label] = dict(wall_s=wall,
                                     stages=stages.stages[n_stage:])
            t0 = time.perf_counter()
            rc = planck.main(base + ["-o", ref_out, "--no-batch-cells",
                                     "--precision", "refine"] + extra)
            grid_times[label]["refine_per_cell_wall_s"] = (
                time.perf_counter() - t0)
            if rc != 0:
                raise AssertionError(f"grid {label} refine: exit {rc}")
            got = read_tables(out, mode, datasets)
            want = read_tables(ref_out, mode, datasets)
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
            ok = worst <= DLNZ_TOL
            phase("grid", mode=label, datasets=datasets, tables=len(got),
                  max_abs_dlnz_vs_refine_per_cell=worst, tol=DLNZ_TOL,
                  launches=c.counts, ok=ok)
            if not ok:
                raise AssertionError(f"grid {label}: |dlnZ| {worst}")
    grid_log.removeHandler(stages)
    phase("launches", path="main paths, total", **total)
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched by the main "
                                 "paths")

    # 5. times, kernel beside plain, at the main paths' shapes
    lat_t = cu(lat_theta - lat_theta.mean(0))
    timed = [("knn_select_small_k", small, x, 9, "self N=65536 d=8 k=9"),
             ("knn_select_large_k", large, x, 44,
              "self N=65536 d=8 k=44 (retry of kmax=5)"),
             ("knn_select_large_k", large, lat_t, 32,
              "self N=64000 d=3 k=32 (lattice retry)"),
             ("knn_select_large_k", large, x, 14, "self N=65536 d=8 k=14"),
             ("knn_select_large_k", large, x, 26, "self N=65536 d=8 k=26")]
    times = {}
    for name, fn, q, k, shape in timed:
        ms = cuda_ms(lambda: fn(q, q, k, self_mode=True))
        plain_ms = cuda_ms(lambda: kh.knn_select_torch(q, q, k,
                                                       self_mode=True))
        pairs = float(q.shape[0]) * q.shape[0]
        phase("time", kernel=name, shape=shape, ms=ms, plain_ms=plain_ms,
              pairs_per_s=pairs / (ms * 1e-3),
              plain_pairs_per_s=pairs / (plain_ms * 1e-3), gpu=smi)
        times.setdefault(name, (ms, plain_ms))
    qb = cu(np.stack([bench_chain(16384, 8, seed=s)[0] for s in range(4)])
            - np.arange(1.0, 9.0))
    nb = [16384] * 4
    for k in (6, 26):
        ms = cuda_ms(lambda: kh.knn_select_batched(qb, qb, k, self_mode=True,
                                                   nr=nb, nq=nb))
        plain_ms = cuda_ms(lambda: kh.knn_select_torch_batched(
            qb, qb, k, self_mode=True, nr=nb, nq=nb))
        pairs = 4.0 * 16384 * 16384
        phase("time", kernel="knn_select_batched",
              shape=f"self B=4 Nq=Nr=16384 d=8 k={k}", ms=ms,
              plain_ms=plain_ms, pairs_per_s=pairs / (ms * 1e-3),
              plain_pairs_per_s=pairs / (plain_ms * 1e-3), gpu=smi)
        times.setdefault("knn_select_batched", (ms, plain_ms))
    walls = {}
    for precision in ("refine", "device", "device", "refine"):
        t0 = time.perf_counter()
        evidence_fn(theta, lnl, kmax=5, precision=precision, device="cuda")
        walls.setdefault(precision, []).append(time.perf_counter() - t0)
    phase("time_evidence_fn", shape="auto N=65536 d=8 kmax=5, no ingest",
          first_refine_s=auto_s, first_device_s=dev_auto_s,
          refine_s=walls["refine"], device_s=walls["device"], gpu=smi)
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
    kernels = [
        {"name": "knn_select_small_k", "route": "cuda", "source": src,
         "replaces": "mcevidence_tpu/ops/knn_pallas.py:275"},
        {"name": "knn_select_large_k", "route": "cuda", "source": src,
         "replaces": "mcevidence_tpu/ops/knn_pallas.py:892",
         "also_replaces": "mcevidence_tpu/ops/knn_pallas.py:749"},
        {"name": "knn_select_batched", "route": "cuda", "source": src,
         "replaces": "mcevidence_tpu/ops/knn_pallas.py:371"},
    ]
    for kern in kernels:
        nm = kern["name"]
        kern.update(launches=total[nm],
                    max_abs_err=max(a for _, a in errs[nm]),
                    max_rel_d2_err=max(r for r, _ in errs[nm]),
                    ms=times[nm][0], plain_ms=times[nm][1])
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
