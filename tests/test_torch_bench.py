"""The port's benchmark harnesses against bench.py's and the JAX step.

``mcevidence_tpu_torch.bench`` runs bench.py's workload through the port;
on ``--device cpu`` at a small ``MCE_BENCH_N`` its last line must carry
bench.py's schema and its dlnZ gates (timed kernel and fast 3e-3, device
1e-6), and refine's ``knn_s`` split must be the parts of one ``exact_knn``
call.  Its timed step (``evidence_reps``, the port's
``fused_auto_evidence``) is held to bench.py's ``evidence_step`` built from
the JAX package on the same numpy chain (N=2048): with exact selection
against ``whiten_jnp`` + ``knn_select_xla`` + ``log_evidence_from_knn``
within 1e-4 (both in f32), and with 12 low bits against
``knn_select_pallas_packed2`` in interpret mode within 1e-4, a limit an
exact selection misses.  The two
baselines (sklearn and scipy's cKDTree) agree within 1e-10 in ln Z.
``bench_serve`` and ``bench_grid`` run at small sizes on the CPU and are
checked by their JSON lines.  None of the three runs on the CPU when the
card was asked for.
"""

import itertools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mcevidence_tpu.ops.estimator import log_evidence_from_knn
from mcevidence_tpu.ops.knn import knn_select_xla
from mcevidence_tpu.ops.knn_pallas import knn_select_pallas_packed2
from mcevidence_tpu.ops.whiten import whiten_jnp
from mcevidence_tpu_torch import bench, bench_grid
from tests.test_torch_planck import DS, _grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
# bench.py's line (bench.py:368-385) under the port's names, and the
# fields the port adds
SCHEMA = ("metric", "value", "unit", "vs_baseline", "timed_rep_walls_s",
          "device_wall_s", "sklearn_cpu_wall_s", "baseline_impl", "backend",
          "gpu", "workload", "max_abs_dlnz_vs_f64_oracle_timed_kernel",
          "timed_kernel", "max_abs_dlnz_vs_f64_oracle_fast_mode",
          "max_abs_dlnz_vs_f64_oracle_device_mode",
          "device_mode_wall_s_incl_host_prep", "evidence_fn_wall_s",
          "refine_split_s", "launches")
SMALL = {"MCE_BENCH_N": str(N), "MCE_BENCH_REPS": "2",
         "MCE_BENCH_TIMED_ATTEMPTS": "1"}


def _run(args, env=None, timeout=300):
    """``python <args>`` from the repository root; one torch thread, so
    the timings the line holds vary less under a loaded host."""
    full = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=ROOT, env=full, timeout=timeout)


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_cpu_bench_line_has_the_schema_and_meets_the_gates():
    proc = _run(["-m", "mcevidence_tpu_torch.bench", "--device", "cpu"],
                SMALL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = _last_json(proc.stdout)
    assert set(SCHEMA) <= set(line)
    assert "error" not in line and not any(k.startswith("mfu")
                                           for k in line)
    assert line["metric"] == "nn_pairs_per_sec_per_chip"
    assert line["unit"] == "pairs/s"
    assert line["backend"] == "cpu" and line["timed_kernel"] == "plain"
    assert line["workload"] == f"auto evidence N={N} d=8 kmax=5 reps=2"
    assert line["baseline_impl"] in bench.BASELINES
    assert len(line["timed_rep_walls_s"]) == 1
    assert line["device_wall_s"] == min(line["timed_rep_walls_s"]) > 0
    assert line["value"] == pytest.approx(N * N / line["device_wall_s"])
    assert line["vs_baseline"] == pytest.approx(
        line["sklearn_cpu_wall_s"] / line["device_wall_s"])
    assert line["max_abs_dlnz_vs_f64_oracle_timed_kernel"] <= 3e-3
    assert line["max_abs_dlnz_vs_f64_oracle_fast_mode"] <= 3e-3
    assert line["max_abs_dlnz_vs_f64_oracle_device_mode"] <= 1e-6
    assert line["device_mode_wall_s_incl_host_prep"] > 0
    assert set(line["evidence_fn_wall_s"]) == {"refine", "device", "fast"}
    assert all(w > 0 for w in line["evidence_fn_wall_s"].values())
    # the parts of one exact_knn call: they fit in its wall and sum to it
    split = line["refine_split_s"]
    parts = [split[k] for k in ("kernel", "host_refine", "reselect", "rest")]
    assert min(parts) >= 0 and split["kernel"] > 0
    assert sum(parts[:3]) <= split["knn_s"]
    assert sum(parts) == pytest.approx(split["knn_s"], rel=1e-9)
    # on the CPU no kernel launches, and no tensor is on a card
    assert all(n == 0 for n in line["launches"].values())
    assert "knn_select_packed" in line["launches"]
    assert "plain_on_cuda" in line["launches"]


def _jax_evidence_step(theta, lnl, select):
    """bench.py:235-240's ``evidence_step`` on the f32 chain."""
    s = jnp.asarray(theta, jnp.float32)
    w = jnp.ones(len(lnl), jnp.float32)
    white, log_j, _ = whiten_jnp(s)
    d2, _ = select(white)
    return np.asarray(log_evidence_from_knn(
        jnp.sqrt(d2), jnp.asarray(lnl, jnp.float32), w, jnp.sum(w),
        theta.shape[1], log_jacobian=log_j, log_prior_volume=0.0,
        k_start=1), np.float64)


@pytest.mark.parametrize("engine,tol", [("auto", 1e-4),
                                        ("pallas_packed2", 1e-4)])
def test_timed_step_matches_jax_evidence_step(engine, tol):
    theta, lnl = bench.synthetic_chain(N, 8)
    if engine == "auto":
        def select(w):
            return knn_select_xla(w, w, bench.KMAX, self_mode=True,
                                  block_size=2048)
    else:
        def select(w):
            return knn_select_pallas_packed2(w, w, bench.KMAX,
                                             self_mode=True, interpret=True)
    want = _jax_evidence_step(theta, lnl, select)
    tensors = bench.chain_tensors(theta, lnl, "cpu")
    total, got = bench.evidence_reps(*tensors, 1, engine=engine)
    got = got.numpy().astype(np.float64)
    gap = float(np.max(np.abs(got[1:] - want[1:])))
    print(f"{engine}: max |dlnZ| port vs JAX {gap:.3g}")
    assert got.shape == want.shape == (bench.KMAX,)
    assert gap <= tol
    assert float(total) == pytest.approx(float(got[1]))
    if engine != "auto":
        # the truncation moves ln Z by more than the limit (~7e-4 here), so
        # an exact selection in the timed step would fail the check above
        exact = bench.evidence_reps(*tensors, 1, engine="auto")[1]
        trunc = float(np.max(np.abs(exact.numpy()[1:] - want[1:])))
        print(f"exact selection vs JAX's 12 bits {trunc:.3g}")
        assert trunc > 5 * tol


def test_perturbed_reps_sum_their_runs():
    theta, lnl = bench.synthetic_chain(512, 8)
    s, l, w = bench.chain_tensors(theta, lnl, "cpu")
    total, first = bench.evidence_reps(s, l, w, 3, engine="auto")
    runs = [bench.evidence_reps(s + 1e-6 * i, l, w, 1, engine="auto")[1]
            for i in range(3)]
    assert torch.equal(first, runs[0])
    assert float(total) == pytest.approx(float(sum(r[1] for r in runs)),
                                         rel=1e-6)


def test_baselines_agree():
    theta, lnl = bench.synthetic_chain(N, 8)
    sk = bench.sklearn_reference(theta, lnl, bench.KMAX, impl="sklearn")
    kd = bench.sklearn_reference(theta, lnl, bench.KMAX,
                                 impl="scipy_ckdtree")
    assert sk.shape == kd.shape == (bench.KMAX - 1,)
    assert np.all(np.isfinite(sk))
    np.testing.assert_allclose(kd, sk, rtol=0, atol=1e-10)
    assert bench.baseline_impl() == "sklearn"      # sklearn is installed
    with pytest.raises(ValueError, match="unknown baseline"):
        bench.sklearn_reference(theta, lnl, bench.KMAX, impl="faiss")


def _py(code):
    return _run(["-c", code], timeout=60)


def test_watchdog_fires_with_schema_line_naming_the_phase():
    p = _py("from mcevidence_tpu_torch import bench; import time; "
            "w = bench._Watchdog(); w.pet('warmup-build', 0.3); "
            "time.sleep(30)")
    assert p.returncode == 2
    d = _last_json(p.stdout)
    assert d["metric"] == "nn_pairs_per_sec_per_chip"
    assert d["value"] == 0.0 and d["vs_baseline"] == 0.0
    assert d["phase"] == "warmup-build"
    assert "warmup-build" in d["error"]


def test_watchdog_pet_rearms_instead_of_stacking():
    p = _py("from mcevidence_tpu_torch import bench; import time; "
            "w = bench._Watchdog(); w.pet('a', 0.2); w.pet('b', 5.0); "
            "time.sleep(0.5); w.cancel(); print('clean')")
    assert p.returncode == 0
    assert p.stdout.strip() == "clean"


def test_watchdog_cancel_is_clean():
    p = _py("from mcevidence_tpu_torch import bench; import time; "
            "w = bench._Watchdog(); w.pet('x', 0.3); w.cancel(); "
            "time.sleep(0.6); print('clean')")
    assert p.returncode == 0
    assert p.stdout.strip() == "clean"


def test_failure_line_schema_with_phase():
    d = json.loads(bench._failure_line("boom", "timed-run"))
    assert d == {"metric": "nn_pairs_per_sec_per_chip", "value": 0.0,
                 "unit": "pairs/s", "vs_baseline": 0.0, "error": "boom",
                 "phase": "timed-run"}
    assert "phase" not in json.loads(bench._failure_line("boom"))


@pytest.mark.parametrize("module", ["bench", "bench_serve", "bench_grid"])
def test_harness_refuses_cuda_without_a_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default is valid here")
    args = ["-m", f"mcevidence_tpu_torch.{module}", "--device", "cuda"]
    if module == "bench_grid":
        args += [str(tmp_path), str(tmp_path / "out")]
    proc = _run(args, SMALL if module == "bench" else
                {"MCE_SERVE_BENCH_SIZES": "500,1000"}, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    if module == "bench":
        d = _last_json(proc.stdout)
        assert d["value"] == 0.0 and d["phase"] == "device-init"
        assert "RuntimeError" in d["error"]
    else:
        # nothing ran: no result line, no table
        assert proc.stdout.strip() == ""


def test_bench_serve_cpu_stream_and_concurrency():
    proc = _run(["-m", "mcevidence_tpu_torch.bench_serve", "1",
                 "--clients", "1,2", "--device", "cpu"],
                {"MCE_SERVE_BENCH_SIZES": "500,1000"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "concurrency scaling (8 requests" in proc.stdout
    line = _last_json(proc.stdout)
    assert line["metric"] == "serve_request_wall_s"
    assert line["device"] == "cpu" and "gpu" in line
    assert set(line["sizes"]) == {"500", "1000"}
    for stats in line["sizes"].values():
        assert stats["requests"] == 1
        assert stats["first"] == stats["p50"] == stats["p95"] > 0
    assert line["requests"] == 2
    assert line["req_per_s"] == pytest.approx(2 / line["stream_wall_s"])
    conc = line["concurrency"]
    assert conc["sizes"] == [500, 1000] and conc["requests"] == 8
    assert [leg["clients"] for leg in conc["legs"]] == [1, 2]
    assert conc["legs"][0]["speedup_vs_k1"] == 1.0
    for leg in conc["legs"]:
        assert leg["req_per_s"] == pytest.approx(8 / leg["wall_s"])
        assert leg["speedup_vs_k1"] == pytest.approx(
            conc["legs"][0]["wall_s"] / leg["wall_s"])


def test_bench_serve_percentiles():
    from mcevidence_tpu_torch.bench_serve import _steady
    walls = [9.0] + [float(i) for i in range(1, 21)]
    assert _steady(walls) == (9.0, 11.0, 19.0)
    assert _steady([0.5]) == (0.5, 0.5, 0.5)


@pytest.mark.parametrize("nchain,mode", [(0, "AllChains"),
                                         (2, "SingleChains")])
def test_bench_grid_cold_and_warm(tmp_path, capsys, nchain, mode):
    grid = _grid(tmp_path / "grid")
    outbase = str(tmp_path / "out")
    rc = bench_grid.main([grid, outbase, str(nchain), "2", "--device",
                          "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "RUN 0: rc=0" in out and "RUN 1: rc=0" in out
    line = _last_json(out)
    assert line["metric"] == "grid_wall_s" and line["device"] == "cpu"
    assert line["mode"] == (f"-nc {nchain}" if nchain else "AllChains")
    assert [r["rc"] for r in line["runs"]] == [0, 0]
    assert line["cold_wall_s"] == line["runs"][0]["wall_s"] > 0
    assert line["warm_wall_s"] == [line["runs"][1]["wall_s"]]
    assert "gpu" in line
    # the warm run reads the parse cache and writes the same table
    tables = [pd.read_csv(os.path.join(r["out"], mode, "csv",
                                       f"mce_{DS}.csv"), index_col=0)
              for r in line["runs"]]
    assert len(tables[0]) == 2
    pd.testing.assert_frame_equal(tables[0], tables[1])
    lnz = [c for c in tables[0].columns
           if c.startswith("chain") or c.startswith("AllChains")]
    assert lnz and np.all(np.isfinite(tables[0][lnz].to_numpy(float)))


def test_harnesses_import_without_jax():
    code = ("import sys\n"
            "import mcevidence_tpu_torch.bench\n"
            "import mcevidence_tpu_torch.bench_serve\n"
            "import mcevidence_tpu_torch.bench_grid\n"
            "print('JAX', 'jax' in sys.modules,\n"
            "      any(m.split('.')[0] == 'mcevidence_tpu'\n"
            "          for m in sys.modules))\n")
    proc = _run(["-c", code], timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX False False" in proc.stdout


@pytest.mark.parametrize("chain", ["gaussian", "lattice"])
def test_split_parts_are_timed_pieces_of_one_refine_knn(chain, monkeypatch):
    from mcevidence_tpu_torch.ops import knn as knn_mod
    from mcevidence_tpu_torch.ops.whiten import apply_whiten, whiten_stats
    if chain == "gaussian":
        theta, _ = bench.synthetic_chain(1024, 8)
    else:
        # a lattice's tied distances make the guard re-select at kmax=2
        theta = np.array(list(itertools.product(range(8), repeat=3)), float)
    white = apply_whiten(theta, whiten_stats(theta))
    cpu = torch.device("cpu")
    assigned = []

    class Watched(type(knn_mod)):
        def __setattr__(self, name, value):
            assigned.append(name)
            super().__setattr__(name, value)
    monkeypatch.setattr(knn_mod, "__class__", Watched)
    d, split = bench.refine_split(white, 2, cpu)
    # the timed call is exact_knn's own: ops.knn's functions are never
    # replaced
    assert assigned == []
    np.testing.assert_array_equal(d, knn_mod.exact_knn(white, None, 2,
                                                       device=cpu))
    assert set(split) == {"kernel", "host_refine", "reselect", "rest",
                          "knn_s"}
    assert min(split.values()) >= 0 and split["kernel"] > 0
    assert split["host_refine"] > 0
    assert (split["reselect"] > 0) == (chain == "lattice")
    assert (split["kernel"] + split["host_refine"] + split["reselect"]
            <= split["knn_s"])
    assert sum(split[k] for k in ("kernel", "host_refine", "reselect",
                                  "rest")) == pytest.approx(split["knn_s"],
                                                            rel=1e-9)
