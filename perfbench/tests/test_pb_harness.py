"""CPU tests of the benchmark harness: cells, configurations and metrics
found by name, a cell and a metric added as files, each driver on a tiny
cell, the roofline's count, and no JAX in a run.

    python -m pytest perfbench/tests -q

The test marked ``cuda`` runs a real cell on the card and skips without
one.
"""

import ast
import glob
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

from pb_copy import REPO, make_copy, run, tiny_cell_names

BENCH = os.path.join(REPO, "perfbench")
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("checkout")))


def test_every_cell_config_and_metric_is_found_by_name():
    s = spec()
    names = {w["name"] for w in s["workloads"]}
    configs = {c["name"]: c for c in s["configs"]}
    for w in s["workloads"]:
        with open(os.path.join(BENCH, "cells", f"{w['name']}.json")) as fh:
            cell = json.load(fh)
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           f"{cell['driver']}.py"))
        assert os.path.isfile(os.path.join(REPO,
                                           configs[w["config"]]["file"]))
        assert cell["limits"] and cell["control"]
    for m in s["per_layer"]:
        mod = load(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                   "m_" + m["name"].replace(".", "_"))
        assert callable(mod.read)
    for m in s["end_to_end"] + s["per_layer"]:
        assert set(m.get("workloads", ())) <= names


@pytest.mark.parametrize("cell", tiny_cell_names())
def test_each_driver_runs_a_tiny_cell_on_the_cpu(copy, cell):
    rc, last, err = run(copy, "--workload", cell, "--seed", "3000000007",
                        "--seconds", "1", "--trace", "0")
    assert rc == 0, err
    keys = list(last)
    assert set(keys) == CONTRACT_KEYS | {"build_s", "checks"}
    assert keys[-1] == "checks"
    assert last["correct"] and last["failed"] == 0 and last["attempted"]
    assert set(last["metrics"]) == {"estimate_s", "setup_s"}
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert [ln.split(":")[0] for ln in tail] == [
        f"check {n}" for n in last["checks"]]


def _digests(root):
    out = {}
    for path in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(path) and "__pycache__" not in path:
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_and_a_metric_added_as_files_run_without_an_edit(tmp_path):
    dst = make_copy(str(tmp_path))
    with open(os.path.join(dst, "perfbench", "metrics",
                           "tiny_units.chain.py"), "w") as fh:
        fh.write("def read(r):\n    return float(len(r['units']))\n")
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as fh:
        s = json.load(fh)
    s["per_layer"].append({"name": "tiny_units.chain", "unit": "estimates",
                           "better": "higher", "source": "host_clock",
                           "layer": "array ingest", "moves": "estimate_s",
                           "workloads": ["tiny-refine"]})
    with open(path, "w") as fh:
        json.dump(s, fh)
    rc, last, err = run(dst, "--workload", "tiny-refine", "--seed", "11",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err
    assert last["metrics"]["tiny_units.chain"]["value"] >= 1
    assert last["correct"]
    # every file the benchmark already had is as it was
    theirs = _digests(os.path.join(dst, "perfbench"))
    for rel, digest in _digests(BENCH).items():
        if not rel.startswith("tests"):
            assert theirs[rel] == digest, rel


def test_the_roofline_counts_the_work_and_not_the_kernel():
    import yardstick
    mod = load(os.path.join(BENCH, "metrics",
                            "knn_select_roofline.chain.py"), "roof")
    flops, nbytes = yardstick.self_selection(65536, 8, 5)
    assert flops == 2.0 * 8 * (65536 ** 2 + 2 * 65536)

    def reading(kernel):
        tracer = types.SimpleNamespace(
            done=True, units=3, flops=3 * flops, nbytes=3 * nbytes,
            events=[{"cat": "kernel", "name": kernel, "ph": "X",
                     "ts": 0.0, "dur": 3 * 4500.0}])
        return mod.read({"tracer": tracer})

    small = reading("void knn::knn_small_k_kernel<knn::Padded<8>, 8>(...)")
    large = reading("void knn::knn_large_k_kernel<knn::Padded<8>, 8>(...)")
    assert small == large == pytest.approx(
        100 * yardstick.bound_seconds(flops, nbytes) / 4.5e-3)
    assert reading("void at::native::reduce_kernel<...>") is None


def test_no_jax_module_is_loaded_by_a_run(copy):
    code = ("import json, sys; sys.path.insert(0, 'perfbench'); import run;"
            " r = run.run_cell('tiny-device', 5, 0.5, 0, 'cpu',"
            " root=sys.argv[1]);"
            " print(json.dumps([run.forbidden_modules(), r['correct'],"
            " 'mcevidence_tpu_torch' in sys.modules]))")
    proc = subprocess.run([sys.executable, "-c", code, copy], cwd=copy,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    found, correct, port = json.loads(proc.stdout.strip().splitlines()[-1])
    assert found == [] and correct and port


def _bare_copy(dst, with_program):
    import shutil
    shutil.copytree(BENCH, os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    if with_program:
        os.symlink(os.path.join(REPO, "mcevidence_tpu_torch"),
                   os.path.join(dst, "mcevidence_tpu_torch"))
    return str(dst)


def _bare_run(dst, *extra):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "chain65k-device", "--seed", "1", "--seconds",
                           "1", *extra], cwd=dst, capture_output=True,
                          text=True, timeout=300)


def test_without_a_card_a_run_fails_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _bare_run(_bare_copy(tmp_path, True))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    proc = _bare_run(_bare_copy(tmp_path, False), "--device", "cpu")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run as harness
    monkeypatch.setitem(sys.modules, "mcevidence_tpu_torch_like", sys)
    assert "mcevidence_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mcevidence_tpu.ops", sys)
    assert "mcevidence_tpu" in harness.forbidden_modules()


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert _imports(path) <= {"numpy", "torch", "math", "reference"}, path
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "mcevidence_tpu"}, path


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")


@pytest.mark.cuda
def test_a_real_cell_runs_on_the_card(card):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "chain65k-device", "--seed", "2147483999",
                           "--seconds", "2", "--trace", "1"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] and last["device"]["platform"] == "gpu"
    assert last["device"]["busy_s"] > 0
