"""The port's grid tools against ``scripts/compare_grids.py`` and
``scripts/synth_grid.py``.

A golden-format AllChains csv directory written here (two datasets, a few
models, ``N_read`` strings, ``ndim``, ``PriorVol``) feeds both
``synth_grid``s, which must write the same files byte for byte.  JAX's
grid driver and the port's (``--device cpu``) then run that grid, and both
comparators read the two trees: the same exit code and the same report
(cells compared, worst |d lnE| and where), on the trees as written (within
1e-9 of each other), on a copy with one cell moved by 1e-5, on the
per-chain (SingleChains) trees and on trees that share no csv.
"""

import contextlib
import filecmp
import importlib.util
import io
import os
import shutil

import pandas as pd
import pytest

from mcevidence_tpu import planck as jax_planck
from mcevidence_tpu_torch import compare_grids, planck, synth_grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the grid driver's first two datasets (``-nd 2``)
DATASETS = tuple(planck.DATASETS[:2])
# dataset -> model -> (N_read as the published tables print it, ndim,
# PriorVol)
GOLDEN = {
    DATASETS[0]: {"base": ("150,140,160,150,", 6, 1.0),
                  "base_omegak": ("120,130,", 7, 0.3),
                  "base_w": (float("nan"), 7, 0.6)},
    DATASETS[1]: {"base": ("300", 6, 1.0),
                  "base_mnu": ("90,90,95,95", 7, 2.5)},
}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("golden")
    for ds, rows in GOLDEN.items():
        pd.DataFrame({"AllChains": [0.0] * len(rows),
                      "N_read": [r[0] for r in rows.values()],
                      "ndim": [r[1] for r in rows.values()],
                      "PriorVol": [r[2] for r in rows.values()]},
                     index=list(rows)).to_csv(out / f"mce_{ds}.csv")
    return str(out)


def tree_files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) for f in fs)


def test_synth_grid_writes_the_scripts_files(golden_dir, tmp_path):
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    assert load_script("synth_grid").main([want, golden_dir]) == 0
    assert synth_grid.main([got, golden_dir]) == 0
    files = tree_files(want)
    # four populated cells (base_w has no N_read), four chain files, a
    # .ranges and a .paramnames each
    assert len(files) == 4 * (4 + 2)
    assert tree_files(got) == files
    _, mismatch, errors = filecmp.cmpfiles(want, got, files, shallow=False)
    assert mismatch == [] and errors == []
    assert synth_grid.golden_cells(golden_dir) == \
        load_script("synth_grid").golden_cells(golden_dir)


def test_synth_grid_needs_the_golden_tables(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        synth_grid.main([str(tmp_path / "out")])
    assert e.value.code == 2
    assert "usage" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")


@pytest.fixture(scope="module")
def trees(golden_dir, tmp_path_factory):
    """JAX's and the port's grid tables of the synthetic grid, in AllChains
    and per-chain mode."""
    top = tmp_path_factory.mktemp("trees")
    grid = str(top / "grid")
    assert synth_grid.main([grid, golden_dir]) == 0
    out = {}
    for label, extra in (("allchains", []), ("nc2", ["-nc", "2"])):
        jax_out, port_out = str(top / f"jax_{label}"), str(top / label)
        base = ["--rootdir", grid, "-v", "0", "-nd", str(len(DATASETS))]
        assert jax_planck.main(base + ["-o", jax_out, "--engine", "xla"]
                               + extra) == 0
        assert planck.main(base + ["-o", port_out, "--device", "cpu"]
                           + extra) == 0
        out[label] = (jax_out, port_out)
    return out


def both_comparators(ref, ours, *tol):
    """(exit code, stdout) of the script's comparator and of the port's."""
    script = load_script("compare_grids")
    runs = []
    for fn in (lambda: script.compare(ref, ours, *map(float, tol)),
               lambda: compare_grids.main([ref, ours, *tol])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn()
        runs.append((rc, buf.getvalue()))
    return runs


def worst(report):
    return float(report.split("max |d lnE| = ")[1].split()[0])


@pytest.mark.parametrize("label", ["allchains", "nc2"])
def test_compare_grids_on_the_two_drivers_trees(trees, label):
    jax_out, port_out = trees[label]
    (rc, text), port = both_comparators(jax_out, port_out, "1e-9")
    assert port == (rc, text)
    assert rc == 0 and worst(text) <= 1e-9
    assert f"over {len(DATASETS)} csv pairs" in text
    if label == "nc2":                        # every chain<i> and the mean
        cols = pd.read_csv(os.path.join(port_out, "SingleChains", "csv",
                                        f"mce_{DATASETS[0]}.csv"),
                           index_col=0).columns
        assert {"chain1", "chain2", "Mean_lnE_k1", "Err_lnE_k1"} <= set(cols)


def test_compare_grids_catches_a_moved_cell(trees, tmp_path):
    jax_out, port_out = trees["allchains"]
    moved = str(tmp_path / "moved")
    shutil.copytree(port_out, moved)
    path = os.path.join(moved, "AllChains", "csv", f"mce_{DATASETS[1]}.csv")
    df = pd.read_csv(path, index_col=0)
    df.loc["base_mnu", "AllChains"] += 1e-5
    df.to_csv(path)
    (rc, text), port = both_comparators(jax_out, moved)
    assert port == (rc, text)
    assert rc == 1
    assert worst(text) == pytest.approx(1e-5, rel=1e-6)
    assert "'base_mnu', 'AllChains'" in text


def test_compare_grids_without_common_tables(trees, tmp_path):
    (rc, text), port = both_comparators(trees["allchains"][0],
                                        str(tmp_path))
    assert port == (rc, text) == (2, "")
    assert compare_grids.main([str(tmp_path)]) == 2
