"""Recertification of the port on the card, written to one JSON artifact.

The counterpart of the repository's ``scripts/tpu_recert.py``.  Run as

    python -m mcevidence_tpu_torch.recert [--out PATH] [--device cuda|cpu]
        [--skip-kernel-cert] [--skip-bench] [--skip-serve]
        [--serve-clients 1,2,4] [--timeout SECONDS]

It runs three legs, each a child process bounded by ``--timeout`` seconds,
and parses each one's output:

1. ``python -m mcevidence_tpu_torch.kernel_cert``: every selection kernel
   against its plain version, one PASS/FAIL line a check;
2. ``python -m mcevidence_tpu_torch.bench``: the port's benchmark line;
3. ``python -m mcevidence_tpu_torch.bench_serve 5 --clients 1,2,4``: the
   service's latency and its concurrency legs.

A leg passes only if its exit code is 0 and its output parses; a nonzero
exit code is recorded and fails the run, whatever the output says.
Skipped legs are left out of the artifact.  The artifact (default
``build/recert.json`` under the checkout, a directory git ignores) holds
each leg's exit code, parsed result and error tail, the card's name and
power limit, and ``ok``; the exit code is 0 only if every leg that ran
passed.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from argparse import ArgumentParser

# the directory that holds the package: the legs run from it
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_REPS = 5


def default_out() -> str:
    return os.path.join(ROOT, "build", "recert.json")


def run_leg(args, timeout):
    """``python -m mcevidence_tpu_torch.<args>`` bounded by ``timeout``
    seconds; never raises.  Returns (exit code, stdout, stderr tail): 124
    at the time limit, 127 when the child could not start."""
    cmd = [sys.executable, "-u", "-m", *args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=ROOT)
        return proc.returncode, proc.stdout, proc.stderr[-2000:]
    except subprocess.TimeoutExpired as exc:
        out = exc.stdout.decode() if isinstance(exc.stdout, bytes) else (
            exc.stdout or "")
        return 124, out, f"timeout after {timeout} s"
    except OSError as exc:
        return 127, "", f"{type(exc).__name__}: {exc}"


def _last_json(out):
    for line in reversed(out.splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def parse_cert(out):
    """The checks of ``kernel_cert``'s output: one a PASS/FAIL line."""
    checks = []
    for line in out.splitlines():
        m = re.match(r"(PASS|FAIL)\s+(.+?)\s+max_rel_d2_err=(\S+)", line)
        if m:
            checks.append({"name": m.group(2), "pass": m.group(1) == "PASS",
                           "max_rel_d2_err": float(m.group(3))})
        elif line.startswith("FAIL "):
            checks.append({"name": line[5:].strip(), "pass": False,
                           "max_rel_d2_err": None})
    return checks


def leg_kernel_cert(device, timeout):
    rc, out, err = run_leg(["mcevidence_tpu_torch.kernel_cert", "--device",
                            device], timeout)
    checks = parse_cert(out)
    n_pass = sum(c["pass"] for c in checks)
    return {"rc": rc, "ok": rc == 0 and bool(checks)
            and n_pass == len(checks),
            "n_pass": n_pass, "n_total": len(checks),
            "worst_rel_d2_err": max((c["max_rel_d2_err"] for c in checks
                                     if c["max_rel_d2_err"] is not None),
                                    default=None),
            "checks": checks, "stderr_tail": err if rc else ""}


def leg_bench(device, timeout):
    rc, out, err = run_leg(["mcevidence_tpu_torch.bench", "--device",
                            device], timeout)
    parsed = _last_json(out)
    ok = (rc == 0 and parsed is not None and "error" not in parsed
          and float(parsed.get("value", 0)) > 0)
    return {"rc": rc, "ok": ok, "parsed": parsed,
            "stderr_tail": err if not ok else ""}


def leg_serve(device, timeout, clients="1,2,4", reps=SERVE_REPS):
    rc, out, err = run_leg(["mcevidence_tpu_torch.bench_serve", str(reps),
                            "--clients", clients, "--device", device],
                           timeout)
    parsed = _last_json(out)
    ok = rc == 0 and parsed is not None and "error" not in parsed
    return {"rc": rc, "ok": ok, "parsed": parsed,
            "stderr_tail": err if not ok else ""}


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.recert",
                       description="kernel cert, bench and service legs as "
                                   "bounded child processes; one JSON "
                                   "artifact")
    p.add_argument("--out", default=None,
                   help="artifact path (default build/recert.json under the "
                        "checkout)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    p.add_argument("--skip-kernel-cert", action="store_true")
    p.add_argument("--skip-bench", action="store_true")
    p.add_argument("--skip-serve", action="store_true")
    p.add_argument("--serve-clients", default="1,2,4")
    p.add_argument("--timeout", type=int, default=2400,
                   help="a leg's time limit, seconds")
    args = p.parse_args(argv)
    from .utils.device import gpu_name_and_power_limit, resolve_device
    dev = resolve_device(args.device)
    out_path = args.out or default_out()
    artifact = {"device": str(dev),
                "gpu": gpu_name_and_power_limit() if dev.type == "cuda"
                else None, "legs": {}}
    legs = artifact["legs"]
    if not args.skip_kernel_cert:
        print("== kernel cert ==", flush=True)
        legs["kernel_cert"] = leg_kernel_cert(str(dev), args.timeout)
        print(f"   -> rc {legs['kernel_cert']['rc']}, "
              f"{legs['kernel_cert']['n_pass']}/"
              f"{legs['kernel_cert']['n_total']} pass", flush=True)
    if not args.skip_bench:
        print("== bench ==", flush=True)
        legs["bench"] = leg_bench(str(dev), args.timeout)
        print(f"   -> rc {legs['bench']['rc']}, value="
              f"{(legs['bench']['parsed'] or {}).get('value')}", flush=True)
    if not args.skip_serve:
        print("== serve concurrency ==", flush=True)
        legs["serve"] = leg_serve(str(dev), args.timeout,
                                  clients=args.serve_clients)
        print(f"   -> rc {legs['serve']['rc']}", flush=True)
    artifact["ok"] = bool(legs) and all(leg["ok"] for leg in legs.values())
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fp:
        json.dump(artifact, fp, indent=1)
    print(f"{'PASS' if artifact['ok'] else 'FAIL'} -> {out_path}",
          flush=True)
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
