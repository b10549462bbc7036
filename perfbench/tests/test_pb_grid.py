"""The grid cell on a tiny grid on the CPU: the driver runs it, a traced
run reports the grid's metrics, and the check that decides ``correct``
passes the program and fails the control and each planted fault.

The tiny cell (``tiny-grid``) is ``grid-allchains`` with three of its
models at ~300 rows; the faults are those a grid can have beyond a chain's:
the H0 reweight dropped, the prior volume not normalised by ``base``'s,
and two models' rows swapped in the table.
"""

import json
import os

import numpy as np
import pytest

import run as harness
from pb_copy import make_copy, run

CELL, REAL = "tiny-grid", "grid-allchains"
GRID_METRICS = ["parse_wait_ms.grid", "prologue_ms.grid",
                "device_stage_ms.grid", "tables_ms.grid",
                "reruns_per_pass.grid"]      # the roofline needs the card


def make_grid_copy(dst):
    """``pb_copy.make_copy`` with a tiny grid configuration and cell, each
    listed where the real grid cell is."""
    make_copy(dst)
    bench = os.path.join(dst, "perfbench")
    with open(os.path.join(bench, "configs", "planck-r2-grid-1ds.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny-grid", models=["base", "base_w", "base_nnu_r"],
               rows=[240, 360])
    with open(os.path.join(bench, "configs", "tiny-grid.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "cells", f"{REAL}.json")) as fh:
        cell = json.load(fh)
    cell.update(config="tiny-grid", traffic=CELL,
                trace={"skip_s": 0.0, "slice_s": 0.2})
    with open(os.path.join(bench, "cells", f"{CELL}.json"), "w") as fh:
        json.dump(cell, fh)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tiny-grid", "source": "tests",
                            "file": "perfbench/configs/tiny-grid.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny-grid",
                              "traffic": CELL, "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(path, "w") as fh:
        json.dump(spec, fh, indent=1)
    return dst


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_grid_copy(str(tmp_path_factory.mktemp("checkout")))


def run_tiny(copy, seed=2147483647, overrides=None):
    return harness.run_cell(CELL, seed, 0.5, 0, "cpu", overrides=overrides,
                            root=copy)


def test_the_grid_driver_runs_a_traced_tiny_cell(copy):
    rc, last, err = run(copy, "--workload", CELL, "--seed", "3000000019",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"] and last["failed"] == 0 and last["attempted"]
    assert set(GRID_METRICS) <= set(last["metrics"])
    assert last["metrics"]["reruns_per_pass.grid"]["value"] == 0


@pytest.mark.parametrize("cell", [CELL])
def test_the_program_passes_and_the_control_fails(copy, cell):
    assert run_tiny(copy)["correct"]
    with open(os.path.join(copy, "perfbench", "cells", f"{cell}.json")) as fh:
        control = json.load(fh)["control"]
    result = run_tiny(copy, overrides=control)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def no_h0_reweight(orig):
    return lambda h0_index, **k: (lambda samples: np.zeros(len(samples)))


def volume_not_over_base(orig):
    def fn(mm, fname, info, use_h0_prior, futures, chain_exts, vol_norm):
        out = orig(mm, fname, info, use_h0_prior, futures, chain_exts, 1.0)
        return out if out is None else (*out[:3], 1.0)
    return fn


def two_rows_swapped(orig):
    def fn(*a, **k):
        df = orig(*a, **k)
        return df.iloc[[1, 0] + list(range(2, len(df)))]
    return fn


# (attribute of mcevidence_tpu_torch.planck, wrapper)
FAULTS = [("make_h0_gauss_lnp", no_h0_reweight),
          ("_model_prologue", volume_not_over_base),
          ("_build_dataset_frame", two_rows_swapped)]


@pytest.mark.parametrize("attr,wrapper", FAULTS,
                         ids=[w.__name__ for _, w in FAULTS])
def test_a_planted_fault_reads_incorrect(copy, monkeypatch, attr, wrapper):
    from mcevidence_tpu_torch import planck
    monkeypatch.setattr(planck, attr, wrapper(getattr(planck, attr)))
    assert not run_tiny(copy)["correct"]
