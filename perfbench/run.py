#!/usr/bin/env python3
"""The benchmark of mcevidence_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run finds the cell's entry in
``BENCHMARK.json``, its data file ``perfbench/cells/<cell>.json`` (its
configuration, traffic, driver, parameters and the limits of its check),
the configuration ``perfbench/configs/<config>.json`` and the driver
``perfbench/traffic/<driver>.py``; with ``--trace 1`` each per-layer
metric's reader ``perfbench/metrics/<metric>.py``.  A cell, a configuration
or a metric is added by adding such files and entries.

It sets up (inputs from ``--seed``, the program loaded and every shape the
cell uses warmed), measures for ``--seconds``, checks every answer the
window produced against the plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``--trace 1`` also ``breakdown``), ``build_s`` (the part of
``setup_s`` that nvcc took) and ``checks``, each compared
number beside its limit, which also close standard error.

It exits non-zero and prints no result without enough CUDA cards (unless
``--device cpu`` is given, which only the tests do), and when a JAX module
or the JAX package is loaded once the window has closed.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mcevidence_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root, workload):
    """(BENCHMARK.json, its workload entry, the cell's data file, the
    configuration file's contents)."""
    bench = os.path.join(root, "perfbench")
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = load_json(os.path.join(bench, "cells", f"{workload}.json"))
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise BenchError(f"cell file's {key} {cell[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    return spec, entry, cell, config


def cell_metrics(spec, workload, trace):
    """The metrics this cell reports: its end-to-end metrics, or with a
    trace its per-layer ones (each listing the cell, or listing no cells
    and moving a metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def prepare_env(root):
    """Keep every compile cache at a fixed path inside the checkout, and
    the program at its defaults; put the checkout and the benchmark's
    modules on the import path."""
    cache = os.path.join(root, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    for key in [k for k in os.environ if k.startswith("MCE_")]:
        del os.environ[key]      # the program's own settings
    if root not in sys.path:
        sys.path.insert(0, root)
    bench = os.path.join(root, "perfbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver's set-up is given: the seed, the device, the
    configuration, the cell's parameters (with any overrides) and a
    scratch directory under the run's TMPDIR."""

    def __init__(self, seed, device, config, params, tmpdir):
        self.seed = seed
        self.device = device
        self.config = config
        self.params = params
        self.tmpdir = tmpdir


def build_seconds():
    """The seconds the program spent building its CUDA libraries in this
    process (nvcc; a checkout's first run only), part of ``setup_s``."""
    build = sys.modules.get("mcevidence_tpu_torch.ops._build")
    return float(sum(build.source_seconds.values())) if build else 0.0


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"


def run_cell(workload, seed, seconds, trace, device_name="cuda",
             overrides=None, root=ROOT, log=sys.stderr):
    """One run; returns the result dict (the line ``main`` prints)."""
    spec, entry, cell, config = find_cell(root, workload)
    bench = os.path.join(root, "perfbench")
    prepare_env(root)
    import torch
    from devtrace import Tracer, breakdown, busy_seconds
    device = torch.device(device_name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < entry["chips"]:
            raise BenchError(f"{torch.cuda.device_count()} card(s); the "
                             f"cell needs {entry['chips']}")
    params = dict(cell["params"], **(overrides or {}))
    tmpdir = os.path.join(tempfile.gettempdir(), "perfbench", workload)
    shutil.rmtree(tmpdir, ignore_errors=True)
    os.makedirs(tmpdir)
    driver = load_module(os.path.join(bench, "traffic",
                                      f"{cell['driver']}.py"),
                         f"perfbench_traffic_{cell['driver']}")
    ctx = Context(seed, device, config, params, tmpdir)
    tr = cell.get("trace", {})
    tracer = Tracer(bool(trace), device, tmpdir, tr.get("skip_s", 1.0),
                    tr.get("slice_s", 3.0))
    try:
        state = driver.setup(ctx)
        tracer.warm()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - T_START
        build_s = build_seconds()
        rec = driver.window(state, seconds, tracer)
        tracer.finish()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = int(torch.cuda.max_memory_allocated(device))
            kind = torch.cuda.get_device_name(device)
        else:
            peak, kind = 0, "cpu"
        driver.release(state)
        t_check = time.perf_counter()
        checks = driver.check(state, rec, cell["limits"])
        rec["check_s"] = time.perf_counter() - t_check
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    correct = (rec["failed"] == 0 and rec["compared"] > 0
               and all(c["value"] <= c["limit"] for c in checks))
    metrics = {}
    if trace:
        readings = dict(driver.layer_inputs(state, rec), cell=workload,
                        tracer=tracer,
                        busy_s=(busy_seconds(tracer.events)
                                if tracer.done else None))
        for m in cell_metrics(spec, workload, True):
            reader = load_module(os.path.join(bench, "metrics",
                                              f"{m['name']}.py"),
                                 "perfbench_metric_" + m["name"].replace(
                                     ".", "_").replace("-", "_"))
            value = reader.read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(state, rec), setup_s=setup_s)
        for m in cell_metrics(spec, workload, False):
            if m["name"] not in values:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": dev}
    if trace:
        if not tracer.done:
            raise BenchError("the window ended before the traced slice")
        dev["busy_s"] = busy_seconds(tracer.events)
        dev["window_s"] = tracer.window_s
        result["breakdown"] = breakdown(tracer.events)
    if device.type == "cuda":
        result["card"] = card_line()
    result["build_s"] = build_s
    result["compared"] = rec["compared"]
    result["check_s"] = rec["check_s"]
    for msg in rec.get("errors", [])[:3]:
        print(f"failed: {msg}", file=log)
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="perfbench/run.py",
                                description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark); cpu only for the tests")
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                          args.device)
    except BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded once the window closed: {found}",
              file=sys.stderr)
        return 3
    print(f"setup_s includes build_s {result['build_s']!r} (nvcc)",
          file=sys.stderr)
    print(f"correct: {result['correct']}, estimates compared: "
          f"{result.pop('compared')} in {result.pop('check_s'):.1f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
