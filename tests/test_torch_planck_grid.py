"""The port's grid driver on a grid written as the benchmark writes it.

A tiny seeded dataset from ``perfbench/gen_grid.py`` (three models with
``base``, ~300 rows each over four CosmoMC files, 70-column records with
``H0*`` among the derived parameters) goes through ``planck.main`` on the
CPU.  Its table is held to ``perfbench/reference/planck_grid.py`` (plain
``np.loadtxt``, the base-normalised prior volume, the H0-reweighted SumW
and a float64 exhaustive search) within 1e-8, the benchmark cell's limit.
The grid's stage spans and counts are read under the dataset's collector
and under one held around the pass.
"""

import json
import os
import sys
import time

import numpy as np
import pandas as pd
import pytest

from mcevidence_tpu_torch import planck
from mcevidence_tpu_torch.ops import pipeline
from mcevidence_tpu_torch.utils.spans import collect, count, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFBENCH = os.path.join(ROOT, "perfbench")
sys.path.insert(0, PERFBENCH)
from gen_grid import write_grid  # noqa: E402
from reference.planck_grid import dataset_table  # noqa: E402

sys.path.remove(PERFBENCH)

DS = planck.DATASETS[0]
KMAX = 3            # the k = 1 column and one _k2 column
LIMIT = 1e-8


def tiny_config():
    with open(os.path.join(PERFBENCH, "configs",
                           "planck-r2-grid-1ds.json")) as fh:
        cfg = json.load(fh)
    cfg.update(models=["base", "base_w", "base_nnu_r"], rows=[240, 360],
               kmax=KMAX)
    return cfg


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    cfg = tiny_config()
    root = str(tmp_path_factory.mktemp("grid"))
    shapes = write_grid(root, 2147483659, cfg)
    ref = dataset_table(root, DS, cfg["models"], cfg["nfiles"], KMAX, "cpu")
    return root, shapes, ref


def run_main(root, out, *extra):
    rc = planck.main(["--rootdir", root, "-o", str(out), "-nd", "1", "-v",
                      "0", "-k", str(KMAX), "--device", "cpu", *extra])
    assert rc == 0
    return pd.read_csv(os.path.join(out, "AllChains", "csv",
                                    f"mce_{DS}.csv"), index_col=0)


def assert_matches_reference(df, ref):
    assert list(df.index) == list(ref)
    got = df[["AllChains", "AllChains_k2"]].to_numpy()
    want = np.array([ref[m] for m in df.index])
    assert np.max(np.abs(got - want)) <= LIMIT


def test_the_written_grid_has_the_published_record_width(grid):
    root, shapes, _ = grid
    assert [s[1] for s in shapes] == [6, 7, 8]
    for model, _, rows in shapes:
        stem = os.path.join(root, model, DS, f"{model}_{DS}")
        tables = [np.loadtxt(f"{stem}_{i}.txt", ndmin=2) for i in range(1, 5)]
        assert {t.shape[1] for t in tables} == {70}
        assert sum(len(t) for t in tables) == rows
        assert planck.h0_index_for_chain(stem) is not None


@pytest.mark.parametrize("precision", ["device", "refine"])
def test_main_matches_the_plain_reference(grid, tmp_path, precision):
    root, _, ref = grid
    assert_matches_reference(
        run_main(root, tmp_path, "--precision", precision), ref)


def test_the_stages_are_spanned_under_the_dataset_collector(
        grid, tmp_path, monkeypatch):
    root, shapes, ref = grid
    logged = []
    orig = planck._stage_log
    monkeypatch.setattr(planck, "_stage_log", lambda ds, timings: (
        logged.append((ds, dict(timings))), orig(ds, timings)))
    timings, spans = {}, []
    t0 = time.perf_counter()
    with collect(timings, spans):
        df = run_main(root, tmp_path)
    wall = time.perf_counter() - t0
    assert_matches_reference(df, ref)
    [(ds, inner)] = logged
    assert ds == DS and inner["grid_cells"] == timings["grid_cells"] == 3
    for stage in ("grid_parse_wait", "grid_prologue", "grid_launch",
                  "grid_fetch", "grid_tables"):
        assert 0 < inner[f"{stage}_s"] <= timings[f"{stage}_s"]
    # the txt, the csv and the aggregate are spanned outside the dataset's
    assert timings["grid_tables_s"] > inner["grid_tables_s"]
    assert "grid_reruns" not in timings
    stages = sum(timings.get(f"{s}_s", 0.0) for s in planck.STAGES)
    assert stages <= wall
    # the device path's own spans run inside the grid's launch
    assert ("device_prep", "grid_launch") in {s[:2] for s in spans}


def _thin(out):
    out[-1] = 1.0               # the thin-margin count of the cell


def _non_finite(out):
    out[0] = float("inf")       # a sum past the f64 range


@pytest.mark.parametrize("fault", [_thin, _non_finite],
                         ids=["thin", "non-finite"])
def test_a_flat_result_that_forces_the_rerun_counts_one(
        grid, tmp_path, monkeypatch, fault):
    root, _, ref = grid
    orig = pipeline.fused_refine_dotp
    calls = []

    def fault_second(*a, **k):
        out = orig(*a, **k)
        calls.append(1)
        if len(calls) == 2:
            out = out.clone()
            fault(out)
        return out

    monkeypatch.setattr(pipeline, "fused_refine_dotp", fault_second)
    timings = {}
    with collect(timings, []):
        df = run_main(root, tmp_path)
    assert timings["grid_reruns"] == 1 and timings["grid_rerun_s"] > 0
    assert_matches_reference(df, ref)


def test_a_collector_inside_another_hands_its_records_out():
    outer_t, outer_s, inner_t, inner_s = {}, [], {}, []
    with collect(outer_t, outer_s):
        with span("grid_launch"):
            with collect(inner_t, inner_s):
                with span("device_prep"):
                    count("grid_cells", 2)
        count("grid_cells")
    assert inner_t["grid_cells"] == 2 and outer_t["grid_cells"] == 3
    assert set(inner_t) == {"device_prep_s", "grid_cells"}
    assert outer_t["device_prep_s"] == inner_t["device_prep_s"]
    assert [s[:2] for s in inner_s] == [("device_prep", "grid_launch")]
    assert [s[:2] for s in outer_s] == [("device_prep", "grid_launch"),
                                        ("grid_launch", None)]
