"""One caller, closed loop: whole passes of the Planck grid driver over one
dataset of CosmoMC text chains, back to back, as a user runs it:

    python -m mcevidence_tpu_torch.planck --rootdir <grid> -o <out> -nd 1 -v 0

(``planck.main``: AllChains, the dataset ``DATASETS[0]``, its tables and
the aggregate step).  The grid is written in set-up from the seed
(``gen_grid.py``); each pass parses its text anew (no parse cache) and
writes its tables into a directory of its own.  Parameters: ``precision``
(given as ``--precision``) and ``warmup`` (passes in set-up).  After the
window every pass's ``mce_<dataset>.csv`` is compared with the plain
reference of the grid's models (``reference/planck_grid.py``).

Each pass runs under a collector (``utils/spans.py``), which holds the
program's grid stage spans and counts (``grid_*``) where the program has
them; the per-layer readers find nothing where it has not.
"""

import csv
import math
import os
import time
import traceback

import numpy as np

from gen_grid import write_grid
from yardstick import self_selection


def setup(ctx):
    from mcevidence_tpu_torch import planck
    cfg = ctx.config
    if planck.DATASETS[0] != cfg["dataset"]:
        raise ValueError(f"-nd 1 runs {planck.DATASETS[0]}, not "
                         f"{cfg['dataset']}")
    grid = os.path.join(ctx.tmpdir, "grid")
    shapes = write_grid(grid, ctx.seed, cfg)
    work = [self_selection(n, d, cfg["kmax"]) for _, d, n in shapes]
    state = {"ctx": ctx, "planck": planck, "grid": grid, "shapes": shapes,
             "work": (sum(f for f, _ in work), sum(b for _, b in work))}
    for i in range(ctx.params.get("warmup", 1)):
        run_pass(state, f"warmup{i}")
    return state


def run_pass(state, tag):
    """One ``planck.main`` pass; returns (its csv, its collector's
    timings)."""
    from torch.profiler import record_function

    from mcevidence_tpu_torch.utils.spans import collect
    ctx = state["ctx"]
    out = os.path.join(ctx.tmpdir, "out", tag)
    argv = ["--rootdir", state["grid"], "-o", out, "-nd", "1", "-v", "0",
            "-k", str(ctx.config["kmax"]),
            "--precision", ctx.params["precision"],
            "--device", str(ctx.device)]
    timings = {}
    with record_function("perfbench.pass"), collect(timings, []):
        rc = state["planck"].main(argv)
    table = os.path.join(out, "AllChains", "csv",
                         f"mce_{ctx.config['dataset']}.csv")
    if rc != 0 or not os.path.isfile(table):
        raise RuntimeError(f"planck.main exited {rc}; {table}: "
                           f"{os.path.isfile(table)}")
    return table, timings


def window(state, seconds, tracer):
    units, errors = [], []
    t0 = time.perf_counter()
    tracer.start_window()
    i = 0
    while time.perf_counter() - t0 < seconds:
        tracer.before_unit()
        ts = time.perf_counter()
        try:
            table, timings = run_pass(state, f"pass{i}")
        except Exception:
            table, timings = None, {}
            errors.append(traceback.format_exc(limit=3))
        te = time.perf_counter()
        tracer.after_unit(*state["work"])
        units.append({"table": table, "wall_s": te - ts, "timings": timings})
        i += 1
    wall = time.perf_counter() - t0
    done = [u for u in units if u["table"] is not None]
    return {"units": units, "wall_s": wall, "attempted": len(units),
            "failed": len(units) - len(done), "completed": len(done),
            "errors": errors, "compared": 0}


def release(state):
    """Free what the program holds on the card before the reference runs."""
    import gc

    import torch
    gc.collect()
    if state["ctx"].device.type == "cuda":
        torch.cuda.empty_cache()


def read_table(path):
    """(row names, {column: [floats]}) of a table as ``planck`` writes it."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    head, body = rows[0], rows[1:]
    names = [r[0] for r in body]
    cols = {}
    for j, name in enumerate(head[1:], 1):
        try:
            cols[name] = [float(r[j]) if r[j] else math.nan for r in body]
        except ValueError:
            continue           # the N_read / N_used strings
    return names, cols


def check(state, rec, limits):
    """The widest gap |ln Z - reference| over every table cell (k = 1 and
    each ``_k<k>`` column) of every pass; a table whose rows are not the
    models in their order reads inf."""
    from reference.planck_grid import dataset_table
    ctx, cfg = state["ctx"], state["ctx"].config
    models = [m for m, _, _ in state["shapes"]]
    ref = dataset_table(state["grid"], cfg["dataset"], models, cfg["nfiles"],
                        cfg["kmax"], ctx.device)
    want = np.array([ref[m] for m in models])          # (models, kmax-1)
    worst = 0.0
    for u in rec["units"]:
        if u["table"] is None:
            continue
        names, cols = read_table(u["table"])
        keys = ["AllChains"] + [f"AllChains_k{k}"
                                for k in range(2, cfg["kmax"])]
        if names != models or any(k not in cols for k in keys):
            gap = math.inf
        else:
            got = np.array([cols[k] for k in keys]).T
            gap = float(np.max(np.abs(got - want)))
            if not math.isfinite(gap):
                gap = math.inf
        worst = max(worst, gap)
        rec["compared"] += 1
    return [{"name": "max_dlnz", "value": worst,
             "limit": limits["max_dlnz"]}]


def end_to_end(state, rec):
    if not rec["completed"]:
        return {}
    cells = rec["completed"] * len(state["shapes"])
    return {"estimate_s": rec["wall_s"] / cells}


def layer_inputs(state, rec):
    return {"units": [u for u in rec["units"] if u["table"] is not None]}
