"""The device precision past 16 coordinates, up to the kernels' widest layout.

Seeded correlated Gaussian chains (``perfbench/gen_chain.py``) of 17 to 64
coordinates go through ``MCEvidence(precision="device", device="cpu")``:
the selection's plain version, then the f64 refine and the
(d2 inv_s2)^(ndim/2) reduction, at the Padded widths 32 and 64 as well as
16.  The f64 refine reproduces exact distances, so the answer is held to
the benchmark's plain reference (``perfbench/reference/knn_evidence.py``)
at 1e-9, where only the order of the sums differs, with no fallback
counted; ``fast`` on the same chains misses that tolerance.  One column
past the layouts (65) falls back and counts it, and so does each other
cause, each named in its log line.
"""

import importlib.util
import logging
import os
import sys

import numpy as np
import pytest

from mcevidence_tpu_torch import MCEvidence
from mcevidence_tpu_torch.ops import pipeline
from mcevidence_tpu_torch.ops.knn_hopper import D_MAX
from mcevidence_tpu_torch.utils.spans import collect
from test_torch_thin_rows import _planted

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGGER = "mcevidence_tpu_torch.ops.pipeline"
WIDTHS = (17, 26, 32, 33, 64)
ROWS = 3000
KMAX = 2
ATOL_REF = 1e-9


def _load(*parts):
    path = os.path.join(ROOT, "perfbench", *parts)
    spec = importlib.util.spec_from_file_location(
        "pb_" + "_".join(parts).replace(".py", ""), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REFERENCE = _load("reference", "knn_evidence.py")
GEN = _load("gen_chain.py")


def _chain(d, n=ROWS, seed=30):
    """A correlated Gaussian chain of n x d with weights 1-4, as the
    benchmark draws them."""
    return GEN.gaussian_chain(GEN.rng_for(seed, d), GEN.rng_for(seed + 1, d),
                              n, d)


def _reference_row(ch, kmax=KMAX):
    return REFERENCE.log_evidence(ch["samples"], ch["loglikes"],
                                  ch["weights"], kmax, "cpu")


def _estimate(ch, precision, verbose=0, **kw):
    mce = MCEvidence(ch, kmax=KMAX, precision=precision, device="cpu",
                     verbose=verbose)
    return mce.evidence(**kw), mce.timings


@pytest.mark.parametrize("d", WIDTHS)
def test_device_path_holds_the_reference_at_width(d):
    ch = _chain(d)
    got, timings = _estimate(ch, "device")
    np.testing.assert_allclose(got, _reference_row(ch), rtol=0,
                               atol=ATOL_REF)
    assert timings["device_fallbacks"] == 0
    assert timings["device_reruns"] == 0
    assert "device_run_s" in timings and "reselect_s" not in timings


@pytest.mark.parametrize("d", WIDTHS)
def test_fast_misses_the_device_tolerance_at_width(d):
    ch = _chain(d)
    got, timings = _estimate(ch, "fast")
    gap = np.max(np.abs(got - _reference_row(ch)))
    assert ATOL_REF < gap < 5e-2
    assert "device_fallbacks" not in timings


def test_one_column_past_the_layouts_falls_back(caplog):
    ch = _chain(D_MAX + 1)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got, timings = _estimate(ch, "device")
    assert timings["device_fallbacks"] == 1
    assert "device_run_s" not in timings
    assert any(f"ndim {D_MAX + 1} > {D_MAX}" in r.getMessage()
               and "falling back to the host refine path" in r.getMessage()
               for r in caplog.records)
    host = pipeline.host_refine_evidence(ch["samples"], ch["loglikes"],
                                         ch["weights"], kmax=KMAX,
                                         device="cpu")
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _reference_row(ch), rtol=0,
                               atol=ATOL_REF)


def _overflowing(d, n=1000):
    """A chain whose outermost row, moved three times as far out, carries
    the top lnL and a weight of 1e-300: its term (d2 inv_s2)^(d/2)
    exp(lnL - lnL_max) / w leaves f64's range on the card, while the host
    path's log-space estimator keeps it."""
    ch = _chain(d, n=n, seed=41)
    s = ch["samples"].copy()
    lnl, w = ch["loglikes"].copy(), ch["weights"].copy()
    out = int(np.argmin(lnl))
    s[out] = 3.0 * s[out] - 2.0 * s.mean(axis=0)
    lnl[out], w[out] = lnl.max(), 1e-300
    return {"samples": s, "loglikes": lnl, "weights": w}


def _budget(monkeypatch):
    monkeypatch.setenv("MCE_DEVICE_HBM_BUDGET_GB", "1e-6")
    return _chain(26, n=1000), {}


def _non_finite(monkeypatch):
    return _overflowing(26), {}


def _unsupported(monkeypatch):
    return _chain(26, n=1000), {"prewhiten": False}


# (cause, its words in the log line, set-up)
CAUSES = [("budget", "exceeds the", _budget),
          ("non-finite", "non-finite sum", _non_finite),
          ("unsupported", "unsupported for this request", _unsupported)]


@pytest.mark.parametrize("cause,words,make", CAUSES,
                         ids=[c[0] for c in CAUSES])
def test_each_fallback_cause_is_named_and_counted(monkeypatch, caplog,
                                                  cause, words, make):
    ch, kw = make(monkeypatch)
    with caplog.at_level(logging.INFO):
        got, timings = _estimate(ch, "device", verbose=1, **kw)
    assert timings["device_fallbacks"] == 1
    assert "device_run_s" not in timings or cause == "non-finite"
    assert any(words in r.getMessage() for r in caplog.records)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("d", [26, 64])
def test_a_term_past_f64_range_is_caught_by_the_host_fallback(d):
    ch = _overflowing(d)
    args = (ch["samples"], ch["loglikes"], ch["weights"])
    t, plan = pipeline._device_refine_prepare(*args, KMAX, 4, device="cpu")
    flat = pipeline._device_refine_pass(t, plan, engine="auto", wait=True)
    assert not np.all(np.isfinite(flat[:-1]))
    assert pipeline.device_refine_finish(flat, plan) is pipeline.NONFINITE
    timings = {}
    with collect(timings, []):
        got = pipeline.device_refine_evidence(*args, kmax=KMAX, device="cpu")
    assert timings["device_fallbacks"] == 1
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, pipeline.host_refine_evidence(
        *args, kmax=KMAX, device="cpu"), rtol=0, atol=1e-12)


def test_a_thin_first_pass_at_26_columns_counts_one_rerun():
    samples, lnl, _ = _planted(n=2000, ndim=26)
    ch = {"samples": samples, "loglikes": lnl,
          "weights": np.ones(len(lnl))}
    got, timings = _estimate(ch, "device")
    assert timings["thin_rows"] == 3
    assert timings["device_reruns"] == 1
    assert timings["device_fallbacks"] == 0
    assert "reselect_s" in timings
    np.testing.assert_allclose(got, _reference_row(ch), rtol=0,
                               atol=ATOL_REF)


def test_the_long_reference_is_the_reference_at_26_columns():
    bench = os.path.join(ROOT, "perfbench")
    sys.path.insert(0, bench)     # it imports reference.knn_evidence
    try:
        long_ref = _load("reference", "knn_evidence_long.py")
    finally:
        sys.path.remove(bench)
    ch = _chain(26)
    np.testing.assert_allclose(
        long_ref.log_evidence(ch["samples"], ch["loglikes"], ch["weights"],
                              KMAX, "cpu"),
        _reference_row(ch), rtol=0, atol=1e-12)


def test_the_plan_counts_the_padded_f32_copy():
    est = pipeline.estimate_device_refine_bytes
    n, k = 1000, 6
    # 32 -> 33 columns: one more column of f64 and f32 coordinates, the
    # padded copy 32 -> 64 columns, one more column of the f64 gather
    assert est(n, n, 33, k) - est(n, n, 32, k) == (
        n * (12 + 32 * 4) + n * k * 3 * 8)
    assert est(n, n, 64, k) - est(n, n, 33, k) == (
        n * 31 * 12 + n * k * 3 * 8 * 31)
