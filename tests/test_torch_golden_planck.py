"""Golden regression of the port against the published Planck full-grid
tables: the counterpart of tests/test_golden_planck.py.

When a real grid directory is given by MCE_PLANCK_GRID and the published
AllChains csv directory by MCE_PLANCK_GOLDEN, the port's grid driver
(``planck.dataset_evidence`` on the CPU) recomputes ln E for every cell
and is held to the published AllChains value within a per-cell tolerance
taken from the published run's own scatter: max(3 x Err_lnE_k1, 0.05),
and 0.5 where a cell has no published Err.  Without the chains that test
skips; the tolerance rule, a copy of tests/test_golden_planck.py's, is
tested here unconditionally on tables written by the test.
"""

import glob
import math
import os

import numpy as np
import pandas as pd
import pytest

from mcevidence_tpu import planck as jax_planck
from mcevidence_tpu_torch import planck
from test_golden_planck import per_cell_tolerance as jax_per_cell_tolerance
from test_planck import _write_chain

TOL_FLOOR = 0.05    # AllChains scatter <= per-chain Err; floor vs tiny Errs
TOL_FALLBACK = 0.5  # no published Err for the cell: config-mistake bound
DATASET = planck.DATASETS[0]


def _singlechains_csv_for(golden_csv: str) -> str:
    """The SingleChains csv carrying Err_lnE_k1 for the same dataset
    (published layout: ``{AllChains,SingleChains}/csv/mce_<dataset>.csv``)."""
    if os.sep + "SingleChains" + os.sep in golden_csv:
        return golden_csv
    return golden_csv.replace(os.sep + "AllChains" + os.sep,
                              os.sep + "SingleChains" + os.sep)


def per_cell_tolerance(golden_csv: str) -> "pd.Series":
    """model -> |dlnE| tolerance, from the golden run's own Err_lnE_k1."""
    sc = _singlechains_csv_for(golden_csv)
    if os.path.exists(sc):
        df = pd.read_csv(sc, index_col=0)
        if "Err_lnE_k1" in df.columns:
            err = pd.to_numeric(df["Err_lnE_k1"], errors="coerce")
            return (3.0 * err).clip(lower=TOL_FLOOR).fillna(TOL_FALLBACK)
    return pd.Series(dtype=float)


# model -> (published Err_lnE_k1, its tolerance)
ERRS = {"base": (0.0604288203275, 3 * 0.0604288203275),    # 3 x Err
        "base_w": (0.0123, TOL_FLOOR),                       # the floor
        "base_nnu": (TOL_FLOOR / 3, TOL_FLOOR),             # at the floor
        "base_mnu": (float("nan"), TOL_FALLBACK),            # no Err
        "base_omegak": ("n/a", TOL_FALLBACK)}                # not a number


def write_tables(top, dataset="plikHM_TT_lowTEB", errs=True):
    """A published-layout pair of csvs for one dataset; returns the
    AllChains one's path."""
    paths = {}
    for mode in ("AllChains", "SingleChains"):
        d = os.path.join(top, mode, "csv")
        os.makedirs(d, exist_ok=True)
        paths[mode] = os.path.join(d, f"mce_{dataset}.csv")
    models = list(ERRS)
    pd.DataFrame({"AllChains": np.linspace(-1.0, 1.0, len(models))},
                 index=models).to_csv(paths["AllChains"])
    cols = {"chain1": np.zeros(len(models)),
            "Mean_lnE_k1": np.zeros(len(models))}
    if errs:
        cols["Err_lnE_k1"] = [e for e, _ in ERRS.values()]
    pd.DataFrame(cols, index=models).to_csv(paths["SingleChains"])
    return paths


@pytest.mark.parametrize("via", ["AllChains", "SingleChains"])
def test_tolerance_rule_on_written_tables(tmp_path, via):
    """3 x Err, the 0.05 floor and the 0.5 fallback, whichever of the two
    csvs the golden path names; the same Series as the JAX test's rule."""
    golden = write_tables(str(tmp_path))[via]
    tol = per_cell_tolerance(golden)
    assert list(tol.index) == list(ERRS)
    for model, (_, want) in ERRS.items():
        assert tol[model] == pytest.approx(want, rel=1e-12), model
    assert (tol >= TOL_FLOOR).all()
    pd.testing.assert_series_equal(tol, jax_per_cell_tolerance(golden))


@pytest.mark.parametrize("layout", ["no SingleChains csv", "no Err column"])
def test_tolerance_rule_without_published_errors(tmp_path, layout):
    paths = write_tables(str(tmp_path), errs=layout == "no Err column")
    if layout == "no SingleChains csv":
        os.remove(paths["SingleChains"])
    else:
        df = pd.read_csv(paths["SingleChains"], index_col=0)
        df.drop(columns="Err_lnE_k1").to_csv(paths["SingleChains"])
    tol = per_cell_tolerance(paths["AllChains"])
    assert tol.empty
    # every cell then takes the fallback, as the chain leg reads it
    assert float(tol.get("base", TOL_FALLBACK)) == TOL_FALLBACK
    pd.testing.assert_series_equal(tol,
                                   jax_per_cell_tolerance(paths["AllChains"]))


def check_golden(grid, golden):
    """Every cell of the port's grid tables against the golden AllChains
    csvs under ``golden`` within its tolerance; returns the cells held."""
    golden_csvs = sorted(glob.glob(os.path.join(golden, "mce_*.csv")))
    assert golden_csvs, f"no golden csvs under {golden}"
    checked = 0
    for gcsv in golden_csvs:
        dataset = os.path.basename(gcsv)[len("mce_"):-len(".csv")]
        gold = pd.read_csv(gcsv, index_col=0)
        tol = per_cell_tolerance(gcsv)
        df = planck.dataset_evidence(grid, dataset, kmax=2, verbose=0,
                                     device="cpu")
        if df is None:
            continue
        for model in df.index:
            if model not in gold.index:
                continue
            ours = df.loc[model, "AllChains"]
            theirs = gold.loc[model, "AllChains"]
            if math.isnan(ours) or math.isnan(theirs):
                continue
            bound = float(tol.get(model, TOL_FALLBACK))
            assert abs(ours - theirs) < bound, (dataset, model, ours,
                                                theirs, bound)
            checked += 1
    return checked


def test_golden_check_on_tables_of_the_jax_driver(tmp_path):
    """The chain leg's check on a mini grid, with JAX's grid driver's
    AllChains and SingleChains tables (the published layout) as the
    golden ones: every cell is held, each within 3 x its Err."""
    rng = np.random.default_rng(2017)
    grid = tmp_path / "grid"
    for model, ndim in (("base", 4), ("base_w", 5)):
        d = grid / model / DATASET
        d.mkdir(parents=True)
        _write_chain(str(d / f"{model}_{DATASET}"), rng, ndim, nchains=4)
    out = str(tmp_path / "published")
    for extra in ([], ["-nc", "4"]):
        assert jax_planck.main(["--rootdir", str(grid), "-o", out, "-v",
                                "0", "-nd", "1", "--engine", "xla",
                                "--kmax", "2"] + extra) == 0
    golden = os.path.join(out, "AllChains", "csv")
    assert check_golden(str(grid), golden) == 2
    tol = per_cell_tolerance(os.path.join(golden, f"mce_{DATASET}.csv"))
    assert list(tol.index) == ["base", "base_w"]


# The published numbers were produced with k=1 (kmax=2), no burn/thin, and
# the H0 Riess-2016 importance prior (reference planck_mcevidence.py
# defaults)
def test_golden_allchains_cells():
    grid = os.environ.get("MCE_PLANCK_GRID", "")
    golden = os.environ.get("MCE_PLANCK_GOLDEN", "")
    if not (grid and os.path.isdir(grid) and golden
            and os.path.isdir(golden)):
        pytest.skip("set MCE_PLANCK_GRID (chain dir) and MCE_PLANCK_GOLDEN "
                    "(published csv dir) to run the golden regression")
    assert check_golden(grid, golden) > 0, \
        "no overlapping cells were compared"
