"""Serving benchmark: steady-state latency and concurrency scaling of the
resident JSON-lines service (``mcevidence_tpu_torch.serve``).

The counterpart of the repository's ``scripts/bench_serve.py``.  Writes
CosmoMC-style toy roots at several chain sizes (d = 6, distinct chain data
per (size, rep)), starts ONE service process
(``python -m mcevidence_tpu_torch.serve --device <dev>``), replays a
shuffled stream of ``kmax: 2, precision: "device"`` requests against it
and reports per-size first, p50 and p95 request wall (the service's own
``wall_s``: host prep, device work and fetch) and the stream's requests
per second.  The first touch of each size pays the kernel library's load;
the steady-state numbers are what a long-lived deployment sees.

Second leg: the stream at the two smallest sizes through
``--workers K`` service processes with K outstanding requests, for each
K of ``--clients``; responses must come back in request order.

Usage::

    python -m mcevidence_tpu_torch.bench_serve [reps_per_size]
        [--clients 1,2,4] [--device cuda|cpu]

``MCE_SERVE_BENCH_SIZES`` (comma-separated rows) replaces the sizes.
Prints a table, then ONE JSON line last.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from argparse import ArgumentParser

import numpy as np

SIZES = (2000, 8000, 32768, 65536)
NDIM = 6
KMAX = 2
# the directory that holds the package: the service children run from it
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_root(dirpath: str, n: int, rng, tag: str = "") -> str:
    """A CosmoMC root of two chains of n // 2 rows drawn from their own
    normalised Gaussian likelihood, with a ``.ranges`` file."""
    root = os.path.join(dirpath, f"toy{n}{tag}")
    names = ["omegabh2", "omegach2", "theta", "tau", "ns", "logA"][:NDIM]
    with open(root + ".ranges", "w") as fp:
        for name in names:
            fp.write(f"{name} -1 1\n")
    mean = np.zeros(NDIM)
    sig = np.full(NDIM, 0.05)
    for c in (1, 2):
        theta = rng.normal(mean, sig, size=(n // 2, NDIM))
        dm = (theta - mean) / sig
        lnl = (-0.5 * np.sum(dm * dm, axis=1)
               - 0.5 * NDIM * math.log(2 * math.pi) - np.sum(np.log(sig)))
        np.savetxt(f"{root}_{c}.txt",
                   np.column_stack([np.ones(n // 2), -lnl, theta]),
                   fmt="%.16e")
    return root


def _start_service(device: str, workers: int = 1) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "mcevidence_tpu_torch.serve",
           "--device", device]
    if workers > 1:
        cmd += ["--workers", str(workers)]
    return subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, cwd=ROOT)


def _stop(proc: subprocess.Popen) -> int:
    """End the service: EOF on its stdin, then a kill if it lingers.
    Returns its exit code."""
    try:
        proc.stdin.close()
        return proc.wait(timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        proc.kill()
        return proc.wait()


def _stream(device, reqs, workers=1, warm=()):
    """One service process with ``workers`` workers: the ``warm`` requests
    one at a time, then ``reqs`` with ``workers`` outstanding.  Returns
    ``_run_stream``'s (total_wall_s, responses) of ``reqs``."""
    proc = _start_service(device, workers)
    try:
        if warm:
            _run_stream(proc, warm)
        out = _run_stream(proc, reqs, window=workers)
    finally:
        rc = _stop(proc)
    if rc != 0:
        raise RuntimeError(f"service exited {rc}")
    return out


def _run_stream(proc: subprocess.Popen, reqs, window: int = 1):
    """Replay ``reqs`` keeping up to ``window`` outstanding; responses are
    read in request order.  Raises on a failed, missing or out-of-order
    response.  Returns (total_wall_s, responses)."""
    responses = []
    t0 = time.perf_counter()
    sent = 0
    for i in range(len(reqs)):
        while sent < len(reqs) and sent - i < window:
            proc.stdin.write(json.dumps(reqs[sent]) + "\n")
            proc.stdin.flush()
            sent += 1
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"service closed its output after {i} of "
                               f"{len(reqs)} responses")
        resp = json.loads(line)
        if not resp.get("ok") or resp.get("id") != reqs[i]["id"]:
            raise RuntimeError(f"request {reqs[i]['id']!r}: {resp}")
        responses.append(resp)
    return time.perf_counter() - t0, responses


def _steady(walls):
    """(first, p50, p95) of one size's walls; p50 and p95 over the warm
    requests (all of them when there is only one)."""
    steady = sorted(walls[1:]) or walls
    p95_ix = min(len(steady) - 1, math.ceil(0.95 * len(steady)) - 1)
    return walls[0], steady[len(steady) // 2], steady[p95_ix]


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.bench_serve",
                       description="latency and concurrency scaling of the "
                                   "JSON-lines service; one JSON line last")
    p.add_argument("reps", nargs="?", type=int, default=5,
                   help="requests per size in the stream (default 5)")
    p.add_argument("--clients", default="1,2,4",
                   help="outstanding requests (= service workers) of the "
                        "concurrency leg, comma-separated")
    p.add_argument("--device", default="cuda",
                   help="the service's device: 'cuda' (default; fails "
                        "without a GPU) or 'cpu'")
    args = p.parse_args(argv)
    from .utils.device import gpu_name_and_power_limit, resolve_device
    device = str(resolve_device(args.device))
    clients = tuple(int(x) for x in args.clients.split(","))
    sizes = SIZES
    if os.environ.get("MCE_SERVE_BENCH_SIZES"):
        sizes = tuple(int(x) for x in
                      os.environ["MCE_SERVE_BENCH_SIZES"].split(","))
    tmp = tempfile.mkdtemp(prefix="mce_serve_bench_")
    try:
        rec = _run(tmp, np.random.default_rng(0), args.reps, clients, sizes,
                   device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["gpu"] = gpu_name_and_power_limit()
    print(json.dumps(rec), flush=True)
    return 0


def _run(tmp, rng, reps, clients, sizes, device) -> dict:
    # distinct chain data per (size, rep): a stream that repeats one root
    # would time the parse cache of a warm process, not the request
    nrep_roots = max(reps, 4)
    conc_sizes = sizes[:2]
    roots = {(n, r): make_root(tmp, n, rng, tag=f"_r{r}")
             for n in sizes for r in range(nrep_roots)}

    def request(n, r, rid):
        return {"id": rid, "root": roots[(n, r)], "kmax": KMAX,
                "precision": "device"}

    reqs = [request(n, r, f"{n}:{r}") for r in range(reps) for n in sizes]
    reqs = [reqs[i] for i in np.random.default_rng(1).permutation(len(reqs))]
    total, responses = _stream(device, reqs)
    walls: dict = {n: [] for n in sizes}
    for resp in responses:
        walls[int(resp["id"].split(":")[0])].append(resp["wall_s"])

    print(f"\n{len(reqs)} requests in {total:.3f}s "
          f"({len(reqs) / total:.2f} req/s end-to-end, one process)")
    print(f"{'rows':>7} {'first':>8} {'p50':>8} {'p95':>8}  (request wall_s)")
    per_size = {}
    for n in sizes:
        first, p50, p95 = _steady(walls[n])
        per_size[str(n)] = {"first": first, "p50": p50, "p95": p95,
                            "requests": len(walls[n])}
        print(f"{n:>7} {first:>8.4f} {p50:>8.4f} {p95:>8.4f}")

    # concurrency leg: K outstanding requests against --workers K, the two
    # smallest sizes, distinct roots per request here too
    conc_reqs = [request(n, r, f"{n}:{r}") for r in range(nrep_roots)
                 for n in conc_sizes]
    conc_reqs = [conc_reqs[i] for i in
                 np.random.default_rng(2).permutation(len(conc_reqs))]
    print(f"\nconcurrency scaling ({len(conc_reqs)} requests, "
          f"rows in {conc_sizes}):")
    print(f"{'clients':>8} {'wall_s':>8} {'req/s':>8} {'vs K=1':>10}")
    legs = []
    for k in clients:
        # each size warmed outside the timed stream
        wall, _ = _stream(device, conc_reqs, workers=k,
                          warm=[request(n, 0, f"w{n}") for n in conc_sizes])
        legs.append({"clients": k, "wall_s": wall,
                     "req_per_s": len(conc_reqs) / wall})
    base = next((leg["wall_s"] for leg in legs if leg["clients"] == 1), None)
    for leg in legs:
        leg["speedup_vs_k1"] = None if base is None else base / leg["wall_s"]
        vs = "" if base is None else f"{leg['speedup_vs_k1']:.2f}x"
        print(f"{leg['clients']:>8} {leg['wall_s']:>8.3f} "
              f"{leg['req_per_s']:>8.2f} {vs:>10}")
    return {"metric": "serve_request_wall_s", "device": device,
            "workload": f"d={NDIM} kmax={KMAX} precision=device, "
                        f"{reps} requests a size",
            "sizes": per_size, "requests": len(reqs), "stream_wall_s": total,
            "req_per_s": len(reqs) / total,
            "concurrency": {"sizes": list(conc_sizes),
                            "requests": len(conc_reqs), "legs": legs}}


if __name__ == "__main__":
    sys.exit(main())
