"""The device path's thin-margin guard re-runs from the first pass's uploads.

A Gaussian chain gets a few planted clusters far out in its tails: a row q
and ten exact copies of one point at distance 1 from it.  Exact copies
stay bit-identical through any whitening, so q's first ten neighbours tie
and q alone is thin (the copies' kmax-th neighbour is another copy, at
distance 0).  ``device_refine_evidence`` then runs the whole chain once
more with 4*pad+8 candidates from the tensors the first pass uploaded, and
must agree with a pass prepped afresh at those candidates, with the
benchmark's plain reference and with the JAX package's device path.  The
planted q rows carry an lnL 3 above the chain's largest, so their terms
weigh in every column.
"""

import importlib.util
import itertools
import logging
import os

import numpy as np
import pytest

from mcevidence_tpu.ops import pipeline as jax_pipeline
from mcevidence_tpu_torch import MCEvidence
from mcevidence_tpu_torch.ops import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGGER = "mcevidence_tpu_torch.ops.pipeline"
ATOL_REF = 1e-9
KMAX = 5
PLANTED = 3


def _reference():
    spec = importlib.util.spec_from_file_location(
        "pb_knn_evidence",
        os.path.join(ROOT, "perfbench", "reference", "knn_evidence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planted(n=2000, ndim=5, seed=11, cross=False):
    """(samples, lnl, samples2): a standard-normal chain with ``PLANTED``
    clusters at 7 sigma on distinct axes, the copies at distance 1 from q.
    Auto mode: q and its ten copies are rows of the chain; cross mode: q
    is a query row and its copies rows of the reference ``samples2`` (a
    second Gaussian draw)."""
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, ndim))
    ref = rng.standard_normal((n, ndim)) if cross else None
    qs, copies = [], []
    for j in range(PLANTED):
        q = np.zeros(ndim)
        q[j] = 7.0 if j % 2 == 0 else -7.0
        u = rng.standard_normal(ndim)
        qs.append(q)
        copies.append(np.repeat((q + u / np.linalg.norm(u))[None],
                                10, axis=0))
    if cross:
        samples, samples2 = np.vstack([theta, qs]), np.vstack([ref, *copies])
    else:
        samples, samples2 = np.vstack([theta, qs, *copies]), None
    lnl = -0.5 * np.sum(samples * samples, axis=1)
    lnl[n:n + PLANTED] = lnl.max() + 3.0
    return samples, lnl, samples2


def _device(samples, lnl, samples2, **kw):
    return pipeline.device_refine_evidence(samples, lnl, samples2=samples2,
                                           kmax=KMAX, device="cpu", **kw)


def _reference_row(samples, lnl, samples2):
    if samples2 is None:
        return _reference().log_evidence(samples, lnl, np.ones(len(lnl)),
                                         KMAX, "cpu")
    # the plain reference has no cross mode: the refine path's host f64
    # estimator on exactly refined neighbours
    return pipeline.host_refine_evidence(samples, lnl, samples2=samples2,
                                         kmax=KMAX, device="cpu")


@pytest.mark.parametrize("mode", ["auto", "cross"])
def test_thin_rows_rerun_from_the_first_uploads(mode, caplog):
    samples, lnl, samples2 = _planted(cross=mode == "cross")
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = _device(samples, lnl, samples2)
    messages = [r.getMessage() for r in caplog.records]
    assert any(f"thin margins on {PLANTED} rows; re-running with 24 extra "
               "candidates" in m for m in messages), messages
    # a pass prepped and uploaded afresh at the retry's candidates
    flat, _, plan = pipeline.device_refine_launch(
        samples, lnl, samples2=samples2, kmax=KMAX, pad_candidates=24,
        device="cpu", wait=True)
    fresh = pipeline.device_refine_finish(flat, plan, last=True)
    np.testing.assert_allclose(got, fresh, rtol=0, atol=1e-12)
    want = jax_pipeline.device_refine_evidence(
        samples, lnl, samples2=samples2, kmax=KMAX, engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)
    np.testing.assert_allclose(got, _reference_row(samples, lnl, samples2),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["auto", "cross"])
def test_a_retry_over_the_budget_falls_back_to_the_host_refine(mode, caplog,
                                                               monkeypatch):
    """A budget between the first pass's plan and the retry's: the first
    pass runs on the card, the retry goes to the host refine path."""
    samples, lnl, samples2 = _planted(cross=mode == "cross")
    n, ndim = samples.shape
    n_ref = len(samples if samples2 is None else samples2)
    first, retry = (pipeline.estimate_device_refine_bytes(
        n, n_ref, ndim, KMAX + pad, cross=samples2 is not None)
        for pad in (4, 24))
    assert first < retry
    monkeypatch.setattr(pipeline, "device_budget_bytes",
                        lambda dev: (first + retry) // 2)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = _device(samples, lnl, samples2)
    messages = [r.getMessage() for r in caplog.records]
    assert any("re-running with 24 extra candidates" in m for m in messages)
    assert any("k_sel=29) exceeds" in m for m in messages), messages
    np.testing.assert_allclose(got, _reference_row(samples, lnl, samples2),
                               rtol=0, atol=1e-10)


def test_mcevidence_counts_the_thin_rows_and_preps_once():
    samples, lnl, _ = _planted()
    mce = MCEvidence({"samples": samples, "loglikes": lnl}, kmax=KMAX,
                     precision="device", device="cpu", verbose=0)
    out = mce.evidence()
    assert mce.timings["thin_rows"] == PLANTED
    names = [s[0] for s in mce.spans]
    assert names.count("device_prep") == names.count("upload") == 1
    assert names.count("device_run") == 2 and names.count("reselect") == 1
    # the re-run's pass runs under reselect, beside the first pass
    assert [s[1] for s in mce.spans if s[0] == "reselect"] == ["fused"]
    assert [s[1] for s in mce.spans if s[0] == "device_run"] == [
        "fused", "reselect"]
    np.testing.assert_allclose(out, _device(samples, lnl, None), rtol=0,
                               atol=1e-12)


def test_a_chain_without_thin_rows_counts_none():
    samples, lnl, _ = _planted()
    n = len(lnl) - 11 * PLANTED
    mce = MCEvidence({"samples": samples[:n], "loglikes": lnl[:n]},
                     kmax=KMAX, precision="device", device="cpu", verbose=0)
    mce.evidence()
    assert "thin_rows" not in mce.timings and "reselect_s" not in mce.timings


def test_the_lattice_reruns_the_whole_chain_from_its_uploads(caplog):
    theta = np.array(list(itertools.product(range(8), repeat=3)), float)
    lnl = -0.05 * np.sum((theta - 3.5) ** 2, axis=1)
    mce = MCEvidence({"samples": theta, "loglikes": -lnl}, kmax=2,
                     precision="device", device="cpu", verbose=0)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        mce.evidence()
    # interior and face rows tie
    assert mce.timings["thin_rows"] > len(theta) // 2
    messages = [r.getMessage() for r in caplog.records]
    assert any("re-running with 24 extra candidates" in m for m in messages)
    names = [s[0] for s in mce.spans]
    assert names.count("device_prep") == names.count("upload") == 1
    assert names.count("device_run") == 2


def test_a_fallback_after_a_thin_pass_runs_under_reselect(monkeypatch):
    """A retry over the budget hands the estimate to the host refine path
    from inside the ``reselect`` span, so ``reselect_ms`` counts it: the
    fallback's first span has ``reselect`` as its parent, and the counts
    name one re-run and one fallback."""
    samples, lnl, _ = _planted()
    n, ndim = samples.shape
    first, retry = (pipeline.estimate_device_refine_bytes(n, n, ndim,
                                                          KMAX + pad)
                    for pad in (4, 24))
    monkeypatch.setattr(pipeline, "device_budget_bytes",
                        lambda dev: (first + retry) // 2)
    mce = MCEvidence({"samples": samples, "loglikes": lnl}, kmax=KMAX,
                     precision="device", device="cpu", verbose=0)
    mce.evidence()
    assert mce.timings["device_reruns"] == mce.timings["device_fallbacks"] == 1
    # the fallback's host refine starts with its host prep, in reselect
    assert [s[1] for s in mce.spans if s[0] == "host_prep"] == [
        "reselect"], mce.spans
    assert [s[1] for s in mce.spans if s[0] == "device_run"] == ["fused"]
