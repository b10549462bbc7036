"""The long-chain cell's driver on a tiny pool on the CPU: the window ends
on whole passes over the pool, a traced run reports the cell's metrics,
and the check that decides ``correct`` passes the program and fails the
control and a fault planted in the thin-margin re-run.

The tiny cell (``tiny-long``) is ``chain1m-device`` at 1200 rows and a
pool of 3.  Its Gaussian chains have no thin rows of their own, so the
thin-row tests make some: the first pass's last candidate of every
``STEP``-th row is set to its kmax-th (a candidate the sum never reads),
which marks the row thin and makes the whole chain run once more.
"""

import json
import os

import numpy as np
import pytest
import torch

import run as harness
from pb_copy import make_copy, run

CELL, REAL = "tiny-long", "chain1m-device"
TINY = {"name": "tiny-long", "rows": 1200, "ndim": 8, "kmax": 5, "pool": 3,
        "weights": [1, 1], "structure_seed": 20170414}
# the span and counter readers (the trace's need the card)
METRICS = ["ingest_ms.chain", "fused_ms.device", "upload_ms.chain",
           "device_prep_ms.device", "device_run_ms.device",
           "launches_per_estimate.chain"]
STEP = 40
WARMUP = 3


def make_long_copy(dst):
    """``pb_copy.make_copy`` with a tiny long-chain configuration and cell,
    each listed where the real cell is."""
    make_copy(dst)
    bench = os.path.join(dst, "perfbench")
    with open(os.path.join(bench, "configs", "long-chain-1m.json")) as fh:
        cfg = json.load(fh)
    cfg.update(TINY)
    with open(os.path.join(bench, "configs", "tiny-long.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "cells", f"{REAL}.json")) as fh:
        cell = json.load(fh)
    cell.update(config="tiny-long", traffic=CELL,
                params=dict(cell["params"], warmup=WARMUP),
                trace={"skip_s": 0.0, "slice_s": 0.2})
    with open(os.path.join(bench, "cells", f"{CELL}.json"), "w") as fh:
        json.dump(cell, fh)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tiny-long", "source": "tests",
                            "file": "perfbench/configs/tiny-long.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny-long",
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
    return make_long_copy(str(tmp_path_factory.mktemp("checkout")))


def run_tiny(copy, seed=2147483647, overrides=None, trace=0):
    return harness.run_cell(CELL, seed, 0.5, trace, "cpu",
                            overrides=overrides, root=copy)


def thin_every_step(monkeypatch):
    """Make every ``STEP``-th row of each pass thin; returns the number of
    rows made thin a chain."""
    from mcevidence_tpu_torch.ops import pipeline
    kmax = TINY["kmax"]
    orig = pipeline.refined_d2_chunks

    def chunks(q64, r64, idx, **k):
        for lo, hi, d2 in orig(q64, r64, idx, **k):
            pick = torch.arange(lo, hi, device=d2.device) % STEP == 0
            d2 = d2.clone()
            d2[pick, -1] = d2[pick, kmax - 1]
            yield lo, hi, d2
    monkeypatch.setattr(pipeline, "refined_d2_chunks", chunks)
    return len(range(0, TINY["rows"], STEP))


def count_passes(monkeypatch):
    """A list that gets the k_sel of every device pass."""
    from mcevidence_tpu_torch.ops import pipeline
    passes, orig = [], pipeline._device_refine_pass

    def counted(t, plan, **kw):
        passes.append(plan["k_sel"])
        return orig(t, plan, **kw)
    monkeypatch.setattr(pipeline, "_device_refine_pass", counted)
    return passes


def test_the_window_ends_on_whole_passes_over_the_pool(copy):
    for seconds in (0.2, 1.5):
        result = harness.run_cell(CELL, 3000000019, seconds, 0, "cpu",
                                  root=copy)
        assert result["correct"] and result["failed"] == 0
        assert result["attempted"] >= TINY["pool"]
        assert result["attempted"] % TINY["pool"] == 0


def test_a_traced_tiny_cell_reports_the_cells_metrics(copy):
    rc, last, err = run(copy, "--workload", CELL, "--seed", "3000000021",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"] and last["failed"] == 0 and last["attempted"]
    assert set(METRICS) <= set(last["metrics"])
    for name in METRICS[:-1]:
        assert last["metrics"][name]["value"] > 0, name


def test_the_program_passes_and_the_control_fails(copy):
    assert run_tiny(copy)["correct"]
    with open(os.path.join(copy, "perfbench", "cells", f"{CELL}.json")) as fh:
        control = json.load(fh)["control"]
    result = run_tiny(copy, overrides=control)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_thin_rows_rerun_pass_and_run_twice(copy, monkeypatch):
    thin_every_step(monkeypatch)
    passes = count_passes(monkeypatch)
    result = run_tiny(copy)
    assert result["correct"], result["checks"]
    # the warm-up's and the window's estimates, each at 9 and then 29
    # candidates
    assert passes == [9, 29] * (WARMUP + result["attempted"])


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_a_fault_in_the_rerun_reads_incorrect(copy, monkeypatch, scale):
    """The re-run's sums scaled: the answer of every estimate moves."""
    from mcevidence_tpu_torch.ops import pipeline
    thin_every_step(monkeypatch)
    orig = pipeline._device_refine_pass

    def faulty(t, plan, **kw):
        flat = orig(t, plan, **kw)
        if plan["k_sel"] > plan["kmax"] + 4:
            flat[:-1] *= scale
        return flat
    monkeypatch.setattr(pipeline, "_device_refine_pass", faulty)
    result = run_tiny(copy)
    assert not result["correct"]
    assert result["checks"]["max_dlnz"]["value"] > 1e-8


@pytest.mark.parametrize("n", [700, 2500])
def test_the_long_reference_finds_the_plain_references_neighbours(
        n, monkeypatch):
    from reference import knn_evidence, knn_evidence_long
    x = np.random.default_rng(n).standard_normal((n, 8))
    want = knn_evidence.neighbour_distances(x, 5, "cpu")
    # blocks of 50 query rows, and a last group of padded columns
    monkeypatch.setattr(knn_evidence_long, "CPU_BLOCK_BYTES", 8 * 3072 * 50)
    got = knn_evidence_long.neighbour_distances(x, 5, "cpu")
    np.testing.assert_array_equal(got, want)
