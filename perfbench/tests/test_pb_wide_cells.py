"""The 26-coordinate device cell at a CPU size, and the readers of the
device path's two counts.

``tiny-26d`` is ``chain26d-device`` at 1500 rows and a pool of 2, on the
same long-chain driver.  It runs ``correct``, and its control, which the
cell file names (``fast`` in place of ``device``), reads incorrect.
The count readers give the count a unit, 0.0 where the count stayed 0,
and nothing where the program keeps no such count.
"""

import json
import os

import numpy as np
import pytest

import run as harness
from pb_copy import REPO, make_copy
from test_pb_harness import load

# (tiny cell, the real cell it stands for, the real cell's configuration,
# the tiny shape)
TINY = [
    ("tiny-26d", "chain26d-device", "des-y1-3x2pt-26d",
     {"rows": 1500, "pool": 2}),
]
READERS = ["device_fallbacks_per_estimate.chain", "reruns_per_estimate.chain"]


def make_wide_copy(dst):
    """``pb_copy.make_copy`` with each tiny cell's configuration and cell,
    each listed where the real cell is."""
    make_copy(dst)
    bench = os.path.join(dst, "perfbench")
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    for cell, real, config, shape in TINY:
        with open(os.path.join(bench, "configs", f"{config}.json")) as fh:
            cfg = json.load(fh)
        cfg.update(shape, name=cell)
        with open(os.path.join(bench, "configs", f"{cell}.json"), "w") as fh:
            json.dump(cfg, fh)
        with open(os.path.join(bench, "cells", f"{real}.json")) as fh:
            data = json.load(fh)
        data.update(config=cell, traffic=cell,
                    params=dict(data["params"], warmup=1),
                    trace={"skip_s": 0.0, "slice_s": 0.2})
        with open(os.path.join(bench, "cells", f"{cell}.json"), "w") as fh:
            json.dump(data, fh)
        spec["configs"].append({"name": cell, "source": "tests",
                                "file": f"perfbench/configs/{cell}.json",
                                "reduced": [], "why": "CPU tests"})
        spec["workloads"].append({"name": cell, "config": cell,
                                  "traffic": cell, "chips": 1,
                                  "why": "CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(path, "w") as fh:
        json.dump(spec, fh, indent=1)
    return dst


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_wide_copy(str(tmp_path_factory.mktemp("checkout")))


def run_tiny(copy, cell, seed=2147483647, overrides=None, trace=0):
    return harness.run_cell(cell, seed, 1.0, trace, "cpu",
                            overrides=overrides, root=copy)


def control(copy, cell):
    with open(os.path.join(copy, "perfbench", "cells", f"{cell}.json")) as fh:
        return json.load(fh)["control"]


@pytest.mark.parametrize("cell", [t[0] for t in TINY])
def test_the_program_passes_and_the_control_fails(copy, cell):
    result = run_tiny(copy, cell)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["attempted"] >= 2
    bad = run_tiny(copy, cell, overrides=control(copy, cell))
    assert not bad["correct"]
    assert any(c["value"] > c["limit"] for c in bad["checks"].values())


def test_the_cell_takes_its_limit_and_control_from_its_file():
    bench = os.path.join(REPO, "perfbench")
    with open(os.path.join(bench, "cells", "chain26d-device.json")) as fh:
        wide = json.load(fh)
    assert wide["control"] == {"precision": "fast"}
    assert wide["limits"] == {"max_dlnz": 1e-8}


def test_the_26d_device_estimates_take_the_device_path(copy):
    """Every estimate of the window ran ``device_run`` at 26 columns and
    counted no fallback: the traced line reads 0.0 for both counts."""
    result = run_tiny(copy, "tiny-26d", trace=1)
    assert result["correct"]
    for name in READERS:
        assert result["metrics"][name]["value"] == 0.0, name
    assert result["metrics"]["device_run_ms.device"]["value"] > 0


def test_a_planted_fallback_is_read_and_stays_correct(copy, monkeypatch):
    """A memory budget of one byte sends every estimate to the host refine
    path: one fallback a unit, and the answers are still exact."""
    from mcevidence_tpu_torch.ops import pipeline
    monkeypatch.setattr(pipeline, "device_budget_bytes", lambda dev: 1)
    result = run_tiny(copy, "tiny-26d", trace=1)
    assert result["correct"]
    assert result["metrics"]["device_fallbacks_per_estimate.chain"][
        "value"] == 1.0
    assert result["metrics"]["reruns_per_estimate.chain"]["value"] == 0.0
    assert "device_run_ms.device" not in result["metrics"]


def test_a_planted_fault_at_26_columns_reads_incorrect(copy, monkeypatch):
    from mcevidence_tpu_torch.ops import pipeline
    orig = pipeline.device_refine_evidence

    def shifted(*a, **k):
        return np.asarray(orig(*a, **k), np.float64) + 1e-7
    monkeypatch.setattr(pipeline, "device_refine_evidence", shifted)
    assert not run_tiny(copy, "tiny-26d")["correct"]


def reading(name, *timings):
    path = os.path.join(REPO, "perfbench", "metrics", f"{name}.py")
    return load(path, name.replace(".", "_")).read(
        {"units": [{"timings": t} for t in timings]})


@pytest.mark.parametrize("name,count", [
    ("device_fallbacks_per_estimate.chain", "device_fallbacks"),
    ("reruns_per_estimate.chain", "device_reruns")])
@pytest.mark.parametrize("counts,want", [
    ((1, 0, 0, 1), 0.5),        # two of four estimates
    ((0, 0), 0.0),              # counted at 0: none
    ((None, None), None),       # a program without the count
    ((None, 2), 2.0),           # only the units that count are read
])
def test_the_count_readers(name, count, counts, want):
    timings = [{"fused_s": 0.1} if c is None else {"fused_s": 0.1, count: c}
               for c in counts]
    assert reading(name, *timings) == want
