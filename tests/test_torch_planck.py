"""The port's Planck grid driver against ``mcevidence_tpu.planck``.

Both drivers run the same seeded mini grid (tests/test_planck.py's layout:
two models, two chains each, an ``H0*`` column for the importance prior)
with the same flags, the port on ``device="cpu"``.  The ln Z columns agree
within 1e-9 and the index and the ``N_read``/``N_used``/``ndim``/
``PriorVol`` columns are equal.  Where the JAX driver runs its batched
device program (per-chain mode, or ``MCE_GRID_QUANTUM`` > 1) that program
is itself ~1e-8 from the JAX per-cell path on the CPU (tests/
test_torch_pipeline.py says why), so there the port is held to the JAX
per-cell tables at 1e-9 and to the batched ones at 1e-8.
"""

import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from mcevidence_tpu import planck as jax_planck
from mcevidence_tpu_torch import planck
from mcevidence_tpu_torch.registry import COSMO_PARAMS
from tests.test_planck import _write_chain

DS = "plikHM_TT_lowTEB"
DS2 = "plikHM_TTTEEE_lowTEB"
INFO = ["PriorVol", "ndim", "N_read", "N_used"]
ATOL = 1e-9
ATOL_JAX_GRID = 1e-8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid(rootdir, datasets=(DS,)):
    rng = np.random.default_rng(12345)
    for ds in datasets:
        for model, ndim in [("base", 4), ("base_w", 5)]:
            d = rootdir / model / ds
            d.mkdir(parents=True)
            _write_chain(str(d / f"{model}_{ds}"), rng, ndim)
    return str(rootdir)


@pytest.fixture(scope="module")
def minigrid(tmp_path_factory):
    return _grid(tmp_path_factory.mktemp("grid"))


@pytest.fixture(scope="module")
def twogrid(tmp_path_factory):
    return _grid(tmp_path_factory.mktemp("grid2"), (DS, DS2))


def assert_same_table(got, want, atol=ATOL):
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    for col in INFO:
        assert list(got[col]) == list(want[col]), col
    lnz = [c for c in want.columns if c not in INFO]
    np.testing.assert_allclose(got[lnz].to_numpy(float),
                               want[lnz].to_numpy(float), rtol=0, atol=atol)


# (flags, env): every mode of the driver's dataset loop
MODES = {
    "allchains_device": (dict(batch_cells=True, precision="device"), {}),
    "allchains_device_kmax3": (dict(batch_cells=True, precision="device",
                                    kmax=3), {}),
    "nc1_device": (dict(batch_cells=True, precision="device", nchain=1), {}),
    "nc2_device": (dict(batch_cells=True, precision="device", nchain=2), {}),
    "allchains_cross_device": (dict(batch_cells=True, precision="device",
                                    cross=True, seed=11), {}),
    "nc2_cross_device": (dict(batch_cells=True, precision="device",
                              nchain=2, cross=True, seed=7), {}),
    "allchains_device_quantum2": (dict(batch_cells=True, precision="device"),
                                  {"MCE_GRID_QUANTUM": "2"}),
    "nc2_device_quantum3_remainder": (dict(batch_cells=True,
                                           precision="device", nchain=2),
                                      {"MCE_GRID_QUANTUM": "3"}),
    "allchains_refine_batched": (dict(batch_cells=True, precision="refine",
                                      kmax=3), {}),
    "nc2_refine_batched": (dict(batch_cells=True, precision="refine",
                                nchain=2), {}),
    "allchains_cross_refine_batched": (dict(batch_cells=True,
                                            precision="refine", cross=True,
                                            seed=11), {}),
    "allchains_refine_per_cell": (dict(precision="refine"), {}),
    "nc2_cross_refine_per_cell": (dict(precision="refine", nchain=2,
                                       cross=True, seed=7), {}),
    "nc2_device_per_cell": (dict(precision="device", nchain=2), {}),
}


def _jax_grid_program(flags, env):
    """Whether the JAX driver runs its batched device program here."""
    return (flags.get("batch_cells") and flags.get("precision") == "device"
            and (flags.get("nchain", 0) > 0
                 or int(env.get("MCE_GRID_QUANTUM", "1")) > 1))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataset_evidence_matches_reference(minigrid, monkeypatch, mode):
    flags, env = MODES[mode]
    kw = dict(dict(kmax=2, verbose=0), **flags)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    want = jax_planck.dataset_evidence(minigrid, DS, engine="xla", **kw)
    got = planck.dataset_evidence(minigrid, DS, device="cpu", **kw)
    if _jax_grid_program(flags, env):
        assert_same_table(got, want, atol=ATOL_JAX_GRID)
        want = jax_planck.dataset_evidence(
            minigrid, DS, engine="xla", **dict(kw, batch_cells=False))
    assert_same_table(got, want)


def test_batched_launch_counts_on_cpu_stay_zero(minigrid):
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    kh.reset_launch_counts()
    planck.dataset_evidence(minigrid, DS, nchain=2, batch_cells=True,
                            precision="device", verbose=0, device="cpu")
    assert (kh.knn_select_batched.launches, kh.knn_select_small_k.launches,
            kh.knn_select_large_k.launches) == (0, 0, 0)


def _csvs(outdir, nchain=0):
    mode = "AllChains" if nchain == 0 else "SingleChains"
    return os.path.join(outdir, mode, "csv")


def _assert_same_outputs(got_dir, want_dir, datasets, nchain=0):
    for ds in datasets:
        name = f"mce_{ds}.csv"
        assert_same_table(
            pd.read_csv(os.path.join(_csvs(got_dir, nchain), name),
                        index_col=0),
            pd.read_csv(os.path.join(_csvs(want_dir, nchain), name),
                        index_col=0))
    with open(os.path.join(_csvs(got_dir, nchain),
                           "delta_lnE_all_df.pkl"), "rb") as fh:
        got = pickle.load(fh)
    with open(os.path.join(_csvs(want_dir, nchain),
                           "delta_lnE_all_df.pkl"), "rb") as fh:
        want = pickle.load(fh)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns) == list(datasets)
    np.testing.assert_allclose(got.to_numpy(float), want.to_numpy(float),
                               rtol=0, atol=ATOL)
    mode = "AllChains" if nchain == 0 else "SingleChains"
    for name in ("delta_lnE_all.txt", "mce_planck_fullgrid.txt"):
        assert os.path.exists(os.path.join(got_dir, mode, name))


@pytest.mark.parametrize("extra", [[], ["-nc", "1"], ["--cross", "--seed",
                                                      "3"]],
                         ids=["allchains", "nc1", "cross"])
def test_main_at_its_defaults_matches_reference(twogrid, tmp_path, extra):
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_planck.main(["--rootdir", twogrid, "-o", want, "-v", "0",
                            "--engine", "xla"] + extra) == 0
    assert planck.main(["--rootdir", twogrid, "-o", got, "-v", "0",
                        "--device", "cpu"] + extra) == 0
    nchain = 1 if "-nc" in extra else 0
    _assert_same_outputs(got, want, [DS, DS2], nchain)


def test_resume_skips_completed_datasets(twogrid, tmp_path, caplog):
    out = str(tmp_path / "port")
    args = ["--rootdir", twogrid, "-o", out, "-v", "0", "--device", "cpu"]
    assert planck.main(args) == 0
    first = pd.read_csv(os.path.join(_csvs(out), f"mce_{DS}.csv"),
                        index_col=0)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu_torch.planck"):
        assert planck.main(args + ["--resume"]) == 0
    skipped = [r for r in caplog.records if "skipping" in r.getMessage()]
    assert len(skipped) == 2
    again = pd.read_csv(os.path.join(_csvs(out), f"mce_{DS}.csv"),
                        index_col=0)
    pd.testing.assert_frame_equal(again, first)


def test_two_shards_then_aggregate_only(twogrid, tmp_path):
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_planck.main(["--rootdir", twogrid, "-o", want, "-v", "0",
                            "--engine", "xla"]) == 0
    base = ["--rootdir", twogrid, "-o", got, "-v", "0", "--device", "cpu",
            "--num-shards", "2"]
    # the last shard refuses to merge while the other shard's csv is
    # missing, then merges once both are on disk
    assert planck.main(base + ["--shard-id", "1"]) == 3
    assert planck.main(base + ["--shard-id", "0", "--no-aggregate"]) == 0
    assert planck.main(["--rootdir", twogrid, "-o", got, "-v", "0",
                        "--aggregate-only"]) == 0
    _assert_same_outputs(got, want, [DS, DS2])


def test_procs_forks_the_port(minigrid, tmp_path):
    out = str(tmp_path / "procs")
    assert planck.main(["--rootdir", minigrid, "-o", out, "-v", "0",
                        "--device", "cpu", "--procs", "2"]) == 0
    assert os.path.exists(os.path.join(_csvs(out), f"mce_{DS}.csv"))
    assert os.path.exists(os.path.join(out, "AllChains",
                                       "delta_lnE_all.txt"))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_distributed_two_ranks_match_one_process(twogrid, tmp_path):
    """``--distributed`` under torchrun's environment: two ranks of a gloo
    job on localhost, one dataset each, the last merging after both are
    done; the tables equal the one-process run's."""
    want, got = str(tmp_path / "one"), str(tmp_path / "two")
    assert planck.main(["--rootdir", twogrid, "-o", want, "-v", "0",
                        "--device", "cpu"]) == 0
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mcevidence_tpu_torch.planck", "--rootdir",
         twogrid, "-o", got, "-v", "0", "--device", "cpu", "--distributed"],
        cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    _assert_same_outputs(got, want, [DS, DS2])


@pytest.mark.parametrize("extra,jax_extra,atol", [
    (["--precision", "fast"], ["--precision", "fast", "--no-batch-cells"],
     1e-4),
    (["--engine", "pallas_smalld"], [], ATOL),
    (["--engine", "pallas_smalld", "-nc", "1"], ["-nc", "1",
                                                 "--no-batch-cells"], ATOL),
], ids=["fast", "pallas_smalld", "pallas_smalld_nc1"])
def test_main_fast_and_smalld_match_reference(twogrid, tmp_path, extra,
                                              jax_extra, atol):
    """``--precision fast`` against JAX's per-cell fast tables (its batched
    fast program skips the f64 centring, tests/test_torch_fast.py), and
    ``--engine pallas_smalld`` against JAX's plain XLA selection (a Pallas
    engine needs a TPU) at the driver's defaults."""
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_planck.main(["--rootdir", twogrid, "-o", want, "-v", "0",
                            "--engine", "xla"] + jax_extra) == 0
    assert planck.main(["--rootdir", twogrid, "-o", got, "-v", "0",
                        "--device", "cpu"] + extra) == 0
    nchain = 1 if "-nc" in extra else 0
    for ds in (DS, DS2):
        name = f"mce_{ds}.csv"
        assert_same_table(
            pd.read_csv(os.path.join(_csvs(got, nchain), name), index_col=0),
            pd.read_csv(os.path.join(_csvs(want, nchain), name),
                        index_col=0), atol=atol)


@pytest.mark.parametrize("mode", ["allchains_device", "nc2_device",
                                  "allchains_cross_device",
                                  "nc2_refine_batched"])
def test_smalld_engine_matches_reference(minigrid, monkeypatch, mode):
    """engine='pallas_smalld' through the grid's device and refine paths
    (on the CPU the small-d wrapper takes its plain version) against the
    JAX driver on its plain XLA selection."""
    flags, env = MODES[mode]
    kw = dict(dict(kmax=2, verbose=0), **flags)
    got = planck.dataset_evidence(minigrid, DS, device="cpu",
                                  engine="pallas_smalld", **kw)
    want = jax_planck.dataset_evidence(minigrid, DS, engine="xla",
                                       **dict(kw, batch_cells=False))
    assert_same_table(got, want)


def test_cuda_without_a_card_fails(minigrid, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert planck.main(["--rootdir", minigrid, "-o", str(tmp_path),
                        "-v", "0"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        planck.dataset_evidence(minigrid, DS, verbose=0)


def _wide_grid(root, models, rng):
    """A dataset of ``models`` ((name, ndim) pairs) under ``root``: ndim 5
    as ``_write_chain`` writes it, wider ones Gaussian chains whose
    .ranges names ndim parameters (the registry's cosmological names, then
    ``nuis<i>``, which the caller registers as cosmological)."""
    names = list(COSMO_PARAMS) + [f"nuis{i}" for i in range(64)]
    for model, ndim in models:
        d = root / model / DS
        d.mkdir(parents=True)
        stem = str(d / f"{model}_{DS}")
        _write_chain(stem, rng, 5, n=400, h0=False)
        if ndim > 5:
            theta = rng.normal(1.0, 0.05, size=(400, ndim))
            neglnl = 0.5 * np.sum(((theta - 1.0) / 0.05) ** 2, axis=1)
            for c in (1, 2):
                np.savetxt(f"{stem}_{c}.txt", np.column_stack(
                    [np.ones(400), neglnl, theta]))
            with open(stem + ".ranges", "w") as fh:
                fh.writelines(f"{nm} 0 2\n" for nm in names[:ndim])
    return names[len(COSMO_PARAMS):]


def test_wide_cells_take_the_host_refine_path(tmp_path, caplog):
    """A 65-parameter cell, one past the kernels' widest layout, runs one by
    one and falls back from the device path to the host refine path."""
    from mcevidence_tpu import registry as jax_registry
    from mcevidence_tpu_torch import registry
    nuis = _wide_grid(tmp_path, [("base", 4), ("base_w", 65)],
                      np.random.default_rng(5))
    kw = dict(kmax=2, verbose=0, batch_cells=True, precision="device")
    registry.extend_cosmo_params(nuis)
    jax_registry.extend_cosmo_params(nuis)
    try:
        with caplog.at_level(logging.INFO,
                             logger="mcevidence_tpu_torch.planck"), \
                caplog.at_level(logging.INFO,
                                logger="mcevidence_tpu_torch.ops.pipeline"):
            got = planck.dataset_evidence(str(tmp_path), DS, device="cpu",
                                          **kw)
        want = jax_planck.dataset_evidence(str(tmp_path), DS, engine="xla",
                                           **kw)
    finally:
        registry.reset_cosmo_params()
        jax_registry.reset_cosmo_params()
    messages = [r.getMessage() for r in caplog.records]
    assert any("1 cell(s) with ndim > 16 run one by one" in m
               for m in messages)
    assert sum("ndim 65 > 64" in m and "host refine path" in m
               for m in messages) == 1
    assert list(got["ndim"]) == [5, 65]
    assert_same_table(got, want)


def test_a_wide_cell_at_device_runs_the_single_chain_device_path(
        tmp_path, monkeypatch):
    """A 20-parameter cell at device precision runs
    ``device_refine_evidence`` on its own; the table is the JAX package's
    device table of the same grid, its cells equal refine's within 1e-6,
    and the batched model's cells are those of a grid without it."""
    from mcevidence_tpu_torch.ops import pipeline
    rng = np.random.default_rng(6)
    _wide_grid(tmp_path / "wide", [("base", 4), ("base_w", 20)], rng)
    _wide_grid(tmp_path / "narrow", [("base", 4)],
               np.random.default_rng(6))
    widths = []
    orig = pipeline.device_refine_evidence

    def recorded(samples, *a, **k):
        widths.append(np.shape(samples)[1])
        return orig(samples, *a, **k)
    monkeypatch.setattr(pipeline, "device_refine_evidence", recorded)
    kw = dict(kmax=3, verbose=0, batch_cells=True, device="cpu")
    got = planck.dataset_evidence(str(tmp_path / "wide"), DS,
                                  precision="device", **kw)
    assert widths == [20]
    want = jax_planck.dataset_evidence(
        str(tmp_path / "wide"), DS, engine="xla", precision="device",
        **{k: v for k, v in kw.items() if k != "device"})
    assert_same_table(got, want)
    refine = planck.dataset_evidence(str(tmp_path / "wide"), DS,
                                     precision="refine", **kw)
    narrow = planck.dataset_evidence(str(tmp_path / "narrow"), DS,
                                     precision="device", **kw)
    assert list(got["ndim"]) == [5, 20]
    lnz = [c for c in got.columns if c not in INFO]
    np.testing.assert_allclose(got[lnz].to_numpy(float),
                               refine[lnz].to_numpy(float), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[lnz].to_numpy(float)[:1],
                                  narrow[lnz].to_numpy(float))


def test_grid_driver_imports_without_jax_and_fills_without_pandas(minigrid):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import mcevidence_tpu_torch.planck as planck\n"
        "loaded = ('jax' in sys.modules, 'pandas' in sys.modules)\n"
        "paths, names = planck.avail_model_list(sys.argv[1], sys.argv[2])\n"
        "mce = np.full((len(paths), 2, 1), np.nan)\n"
        "info = {k: [] for k in planck.INFO_COLS}\n"
        "planck._dataset_cells_batched(paths, names, ['_1.txt', '_2.txt'],\n"
        "    kmax=2, burnfrac=0.0, thinfrac=0.0, use_h0_prior=True,\n"
        "    mce=mce, info=info, precision='device', device='cpu')\n"
        "print('LOADED', *loaded, 'jax' in sys.modules,\n"
        "      'pandas' in sys.modules, bool(np.isfinite(mce).all()))\n")
    proc = subprocess.run([sys.executable, "-c", code, minigrid, DS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED False False False False True" in proc.stdout
