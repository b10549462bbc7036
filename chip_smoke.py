"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
non-zero.  Without a CUDA device, or without the package beside it, it
fails before printing any result.

1. probe: torch/CUDA versions, the card, nvcc; TF32 switched off.
2. build: nvcc builds ``mcevidence_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernel vs plain: each kernel against ``knn_select_torch`` on the same
   CUDA tensors.  Criterion (scripts/tpu_kernel_cert.py:40-68): the d2
   recomputed in f64 at the kernel's indices, sorted, within 2^-10 relative
   of the plain version's sorted d2; absent slots and the self pin equal.
4-7. the main path through the user's entry points (``evidence_fn`` auto,
   cross, a lattice whose ties force the refine guard's retry, and the CLI),
   each held to |dlnZ| <= 1e-6 against an f64 oracle: whitening and the
   estimator written out here, fed by an f64 brute-force kNN on the card.
   Both kernels' launch counts must rise during these phases.
8. times: kernel vs plain at the main path's shapes, and evidence_fn's wall
   time, each printed with the card's name and power limit.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
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


def compare(name, kernel, query, ref, k, self_mode, nr=None):
    """One kernel-vs-plain leg on CUDA tensors; returns (max_rel, max_abs)."""
    from mcevidence_tpu_torch.ops.knn_hopper import knn_select_torch
    kd2, kidx = kernel(query, ref, k, self_mode=self_mode, nr=nr)
    pd2, pidx = knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr)
    torch.cuda.synchronize()
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
    ok = rel <= REL_TOL
    phase("kernel_vs_plain", leg=name, k=k, nq=query.shape[0],
          nr=ref.shape[0] if nr is None else nr, max_rel_d2_err=rel,
          max_abs_d2_err=abs_err, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: max_rel_d2_err {rel} > {REL_TOL}")
    return rel, abs_err


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mcevidence_tpu_torch import MCEvidence, evidence_fn
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

    errs = {"knn_select_small_k": [], "knn_select_large_k": []}
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

    # 4-7. the main path, counted
    theta, lnl = bench_chain(65536, 8, seed=0)
    half = theta.shape[0] // 2
    lat_theta, lat_lnl = lattice_chain()
    kh.reset_launch_counts()
    t0 = time.perf_counter()
    auto = evidence_fn(theta, lnl, kmax=5, device="cuda")
    auto_s = time.perf_counter() - t0
    cross = evidence_fn(theta[:half], lnl[:half], samples2=theta[half:],
                        kmax=5, device="cuda")
    small_after_4_5 = small.launches
    retry = evidence_fn(lat_theta, lat_lnl, kmax=2, device="cuda")
    large_after_6 = large.launches
    with tempfile.TemporaryDirectory() as tmp:
        root = write_toy_root(tmp, np.random.default_rng(3))
        cli_auto = run_cli([root, "-k", "3", "-vb", "0"])
        cli_cross = run_cli([root, "-k", "3", "--cross", "--seed", "1",
                             "-vb", "0"])
    launches = {"knn_select_small_k": small.launches,
                "knn_select_large_k": large.launches}

    checks = [("main_auto", auto, oracle_evidence(theta, lnl, 5)),
              ("main_cross", cross, oracle_evidence(
                  theta[:half], lnl[:half], 5, theta2=theta[half:])),
              ("main_retry", retry, oracle_evidence(lat_theta, lat_lnl, 2))]
    for name, got, want in checks:
        dlnz = float(np.max(np.abs(got - want)))
        ok = bool(got.shape == want.shape and np.all(np.isfinite(got))
                  and dlnz <= DLNZ_TOL)
        phase(name, lnz=got.tolist(), oracle=want.tolist(), max_abs_dlnz=dlnz,
              tol=DLNZ_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"{name}: |dlnZ| {dlnz} > {DLNZ_TOL}")
    if small_after_4_5 == 0:
        raise AssertionError("auto/cross evidence_fn never launched the "
                             "small-k kernel")
    if large_after_6 == 0:
        raise AssertionError("the lattice retry never launched the large-k "
                             "kernel")
    phase("cli", auto=cli_auto, cross=cli_cross, ok=True)
    phase("launches", **launches)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched by the main path")

    # 8. times, kernel beside plain, at the main path's shapes
    lat_t = cu(lat_theta - lat_theta.mean(0))
    timed = [("knn_select_small_k", small, x, 9, "self N=65536 d=8 k=9"),
             ("knn_select_large_k", large, x, 44,
              "self N=65536 d=8 k=44 (retry of kmax=5)"),
             ("knn_select_large_k", large, lat_t, 32,
              "self N=64000 d=3 k=32 (lattice retry)"),
             ("knn_select_large_k", large, x, 14, "self N=65536 d=8 k=14"),
             ("knn_select_large_k", large, x, 26, "self N=65536 d=8 k=26")]
    times = {}
    saved = dict(launches)
    for name, fn, q, k, shape in timed:
        ms = cuda_ms(lambda: fn(q, q, k, self_mode=True))
        plain_ms = cuda_ms(lambda: kh.knn_select_torch(q, q, k,
                                                       self_mode=True))
        pairs = float(q.shape[0]) * q.shape[0]
        phase("time", kernel=name, shape=shape, ms=ms, plain_ms=plain_ms,
              pairs_per_s=pairs / (ms * 1e-3),
              plain_pairs_per_s=pairs / (plain_ms * 1e-3), gpu=smi)
        times.setdefault(name, (ms, plain_ms))
    evid = []
    for _ in range(3):
        t0 = time.perf_counter()
        evidence_fn(theta, lnl, kmax=5, device="cuda")
        evid.append(time.perf_counter() - t0)
    phase("time_evidence_fn", shape="auto N=65536 d=8 kmax=5, no ingest",
          first_s=auto_s, median_s=statistics.median(evid), gpu=smi)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=5,
                     verbose=0, device="cuda")
    stages = []
    for _ in range(3):
        mce.evidence()
        stages.append(dict(mce.timings))
    phase("time_stages", shape="MCEvidence auto N=65536 d=8 kmax=5",
          **{key: statistics.median(t[key] for t in stages)
             for key in ("whiten_s", "knn_s", "estimator_s")},
          ingest_s=mce.timings["ingest_s"], gpu=smi)

    src = "mcevidence_tpu_torch/csrc/knn_select.cu"
    kernels = [
        {"name": "knn_select_small_k", "route": "cuda", "source": src,
         "replaces": "mcevidence_tpu/ops/knn_pallas.py:275"},
        {"name": "knn_select_large_k", "route": "cuda", "source": src,
         "replaces": "mcevidence_tpu/ops/knn_pallas.py:892",
         "also_replaces": "mcevidence_tpu/ops/knn_pallas.py:749"},
    ]
    for kern in kernels:
        nm = kern["name"]
        kern.update(launches=saved[nm],
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
