"""A checkout copy with tiny cells, for the benchmark's CPU tests.

``make_copy(dst)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``dst``, links the program beside them, and adds, as new files and new
entries only, a tiny configuration and cells of each driver (``tiny-*``)
that the CPU runs in seconds.
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_CHAIN = {"name": "tiny-chain", "rows": 600, "ndim": 4, "kmax": 5,
              "pool": 2, "weights": [1, 4], "structure_seed": 7}
# (cell, config, driver, params, control)
TINY_CELLS = [
    ("tiny-refine", "tiny-chain", "chain", {"precision": "refine",
                                            "warmup": 1},
     {"precision": "fast"}),
    ("tiny-device", "tiny-chain", "chain", {"precision": "device",
                                            "warmup": 1},
     {"precision": "fast"}),
]


def tiny_cell_names(driver=None):
    return [c[0] for c in TINY_CELLS if driver in (None, c[2])]


def make_copy(dst):
    bench = os.path.join(dst, "perfbench")
    shutil.copytree(os.path.join(REPO, "perfbench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(REPO, "mcevidence_tpu_torch"),
               os.path.join(dst, "mcevidence_tpu_torch"))
    spec_path = os.path.join(dst, "BENCHMARK.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    for name, cfg in (("tiny-chain", TINY_CHAIN),):
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as fh:
            json.dump(cfg, fh)
        spec["configs"].append({"name": name, "source": "tests",
                                "file": f"perfbench/configs/{name}.json",
                                "reduced": [], "why": "CPU tests"})
    for cell, config, driver, params, control in TINY_CELLS:
        limits = {"max_dlnz": 1e-8}
        with open(os.path.join(bench, "cells", f"{cell}.json"), "w") as fh:
            json.dump({"config": config, "traffic": cell, "driver": driver,
                       "params": params, "control": control,
                       "trace": {"skip_s": 0.0, "slice_s": 0.2},
                       "limits": limits}, fh)
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": cell, "chips": 1,
                                  "why": "CPU tests"})
        add_to_metrics(spec, cell)
    with open(spec_path, "w") as fh:
        json.dump(spec, fh, indent=1)
    return dst


# which real cell each tiny cell stands for, to list it with its metrics
STANDS_FOR = {"tiny-refine": "chain65k-refine",
              "tiny-device": "chain65k-device"}


def add_to_metrics(spec, cell):
    """List the tiny cell with every metric of the cell it stands for."""
    real = STANDS_FOR[cell]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if real in m.get("workloads", ()):
            m["workloads"].append(cell)


def run(dst, *args, timeout=600):
    """``python3 perfbench/run.py *args --device cpu`` in the copy; returns
    (exit code, the last line of standard output parsed or None, standard
    error)."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", *args,
                           "--device", "cpu"], cwd=dst, capture_output=True,
                          text=True, timeout=timeout,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    lines = proc.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            pass
    return proc.returncode, last, proc.stderr
