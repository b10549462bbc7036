"""The port's ``device`` precision against the JAX package's.

The same seeded numpy chains go through ``mcevidence_tpu``'s device path
(``precision="device", engine="xla"``: double-float refinement on the CPU)
and the port's (``device="cpu"``: native f64 refinement, the kernel
wrappers taking their plain version).  Both agree with the refine path to
~1e-13, so they are held to each other at 1e-9, and the port's device path
to its refine path at the reference's own gates (tests/test_evidence.py:
257-301): 1e-6, and 1e-8 in cross mode and on offset coordinates.

One property of the reference bounds the grid comparisons: the JAX batched
device program (``parallel/ring.py:make_sharded_grid_device_refine``) is
jitted whole on XLA:CPU, where fusion breaks its double-float identities
(``ops/pipeline.py:155-164``), so on the CPU it sits up to ~1e-8 from the
JAX per-chain device path.  The port's grid is held to the JAX per-chain
path at 1e-9 and to the JAX grid program at ``ATOL_JAX_GRID``.
"""

import itertools
import logging

import numpy as np
import pytest

import mcevidence_tpu as jx
import mcevidence_tpu_torch as pt
from mcevidence_tpu.ops import pipeline as jax_pipeline
from mcevidence_tpu.parallel import ring as jax_ring
from mcevidence_tpu_torch.ops import pipeline
from mcevidence_tpu_torch.parallel import ring
from tests.conftest import make_gaussian_chain

ATOL_REF = 1e-9
ATOL_JAX_GRID = 1e-8
LOGGER = "mcevidence_tpu_torch.ops.pipeline"


def _chain(seed, n=1200, ndim=4):
    return make_gaussian_chain(np.random.default_rng(seed), n=n, ndim=ndim)


def _lattice():
    theta = np.array(list(itertools.product(range(8), repeat=3)), float)
    return theta, -0.05 * np.sum((theta - 3.5) ** 2, axis=1)


def _offset_chain():
    """tests/test_evidence.py:289-301: a chain ~1e3 sigma from the origin."""
    rng = np.random.default_rng(31)
    mean = np.array([0.0222, 0.12, 1.041])
    sig = np.array([0.0002, 0.002, 0.0005])
    theta = rng.normal(mean, sig, size=(4000, 3))
    dm = (theta - mean) / sig
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 1.5 * np.log(2 * np.pi) - np.sum(np.log(sig)))
    return theta, lnl


def _case(name):
    """(samples, lnlike, kwargs) of one edge case."""
    theta, lnl = _chain(1)
    kw = {"kmax": 4}
    if name == "cross":
        return theta[:600], lnl[:600], dict(kw, samples2=theta[600:])
    if name == "weights":
        w = np.random.default_rng(2).integers(1, 5, len(theta)).astype(float)
        return theta, lnl, dict(kw, weights=w)
    if name == "offset":
        return (*_offset_chain(), {"kmax": 3})
    if name == "duplicates":
        # three exact copies of every point: the k=1, 2 columns are -inf
        return (np.repeat(theta[:300], 3, axis=0), np.repeat(lnl[:300], 3),
                kw)
    if name == "n_below_kmax":
        # fewer rows than kmax: the undefined columns are NaN
        return theta[:3], lnl[:3], {"kmax": 5}
    if name == "ndim_above_16":
        th, ll = _chain(3, n=500, ndim=18)
        return th, ll, {"kmax": 3}
    if name == "lattice_retry":
        return (*_lattice(), {"kmax": 2})
    if name == "sum_adjusted_weights":
        return theta, lnl, dict(kw, sum_adjusted_weights=900.0)
    return theta, lnl, kw


CASES = ["auto", "cross", "weights", "offset", "duplicates", "n_below_kmax",
         "ndim_above_16", "lattice_retry", "sum_adjusted_weights"]


@pytest.mark.parametrize("case", CASES)
def test_device_precision_matches_reference(case, caplog):
    theta, lnl, kw = _case(case)
    want = jx.evidence_fn(theta, lnl, precision="device", engine="xla", **kw)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = pt.evidence_fn(theta, lnl, precision="device", device="cpu",
                             **kw)
    assert got.shape == want.shape == (kw["kmax"] - 1,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL_REF)
    messages = [r.getMessage() for r in caplog.records]
    if case == "duplicates":
        assert np.isneginf(got[:2]).all() and np.isfinite(got[2])
    if case == "n_below_kmax":
        assert np.isnan(got[2:]).all() and np.isfinite(got[:2]).all()
    if case == "ndim_above_16":
        assert any("ndim 18 > 16" in m for m in messages)
    if case == "lattice_retry":
        assert any("re-running with 24 extra candidates" in m
                   for m in messages)


@pytest.mark.parametrize("case,atol", [("weights", 1e-6), ("cross", 1e-8),
                                       ("offset", 1e-8)])
def test_device_precision_matches_refine(case, atol):
    theta, lnl, kw = _case(case)
    ref = pt.evidence_fn(theta, lnl, precision="refine", device="cpu", **kw)
    dev = pt.evidence_fn(theta, lnl, precision="device", device="cpu", **kw)
    np.testing.assert_allclose(dev, ref, rtol=0, atol=atol)


def test_memory_guard_forced_by_its_override(monkeypatch, caplog):
    theta, lnl, kw = _case("auto")
    monkeypatch.setattr(jax_pipeline, "DEVICE_HBM_BUDGET_BYTES", 10_000)
    want = jx.evidence_fn(theta, lnl, precision="device", engine="xla", **kw)
    monkeypatch.setenv("MCE_DEVICE_HBM_BUDGET_GB", "1e-5")

    def boom(*a, **k):
        raise AssertionError("device path run past the memory guard")
    monkeypatch.setattr(pipeline, "fused_refine_dotp", boom)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = pt.evidence_fn(theta, lnl, precision="device", device="cpu",
                             **kw)
    assert any("budget" in r.getMessage() for r in caplog.records)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)
    host = pipeline.host_refine_evidence(theta, lnl, kmax=4, device="cpu")
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-12)


def test_non_finite_sum_falls_back_to_host_refine(monkeypatch, caplog):
    import torch
    theta, lnl = _chain(6, n=600, ndim=3)

    def overflow(*a, kmax, **k):
        flat = torch.zeros(kmax + 1, dtype=torch.float64)
        flat[0] = float("inf")
        return flat
    monkeypatch.setattr(pipeline, "fused_refine_dotp", overflow)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got = pipeline.device_refine_evidence(theta, lnl, kmax=2,
                                              device="cpu")
    assert any("non-finite" in r.getMessage() for r in caplog.records)
    want = jax_pipeline.host_refine_evidence(theta, lnl, kmax=2,
                                             engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)


def test_memory_plan_scales_with_n_and_charges_cross():
    est = pipeline.estimate_device_refine_bytes
    # the f64 gather is chunked over rows: beyond one chunk its term is a
    # constant and the plan grows by the same bytes per row
    step1 = est(2 ** 21, 2 ** 21, 8, 9) - est(2 ** 20, 2 ** 20, 8, 9)
    step2 = est(2 ** 22, 2 ** 22, 8, 9) - est(2 ** 21, 2 ** 21, 8, 9)
    assert step2 == 2 * step1
    assert est(2 ** 20, 2 ** 20, 8, 9, cross=True) > est(2 ** 20, 2 ** 20,
                                                         8, 9)
    # the Planck headline shape plans for well under 1 GiB
    assert est(65536, 65536, 8, 9) < 2 ** 30


@pytest.mark.parametrize("split,covtype", [(False, "all"), (True, "all"),
                                           (True, None)])
def test_mcevidence_device_precision_matches_reference(split, covtype,
                                                       caplog):
    theta, lnl = _chain(8, n=900, ndim=3)
    chain = {"samples": theta, "loglikes": lnl}
    init = dict(kmax=3, verbose=0, split=split, seed=4, precision="device")
    want = jx.MCEvidence(chain, engine="xla", **init).evidence(
        covtype=covtype)
    mce = pt.MCEvidence(chain, device="cpu", **init)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu_torch.evidence"):
        got = mce.evidence(covtype=covtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)
    # cross + covtype='single' (covtype=None takes the constructor's
    # 'single') logs and runs the refine path
    fell_back = any("falling back to precision='refine'" in r.getMessage()
                    for r in caplog.records)
    assert fell_back == (covtype is None)
    assert ("fused_s" in mce.timings) == (covtype is not None)


@pytest.mark.parametrize("case", ["auto", "weights", "offset",
                                  "sum_adjusted_weights", "n_below_kmax"])
def test_fast_pipeline_matches_reference(case):
    """``fast_auto_evidence`` against the JAX one (f32 on both sides: the
    matrix identity against differences, other summation orders)."""
    theta, lnl, kw = _case(case)
    kw = {key: val for key, val in kw.items() if key != "samples2"}
    want = jax_pipeline.fast_auto_evidence(theta, lnl, engine="xla", **kw)
    got = pipeline.fast_auto_evidence(theta, lnl, device="cpu", **kw)
    assert got.shape == np.asarray(want).shape == (kw["kmax"] - 1,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], np.asarray(want)[fin], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["auto", "cross", "weights", "offset",
                                  "duplicates", "lattice_retry"])
def test_smalld_device_precision_matches_reference(case, caplog):
    """engine='pallas_smalld' (K8's counterpart) on the device path, with
    the small-d wrapper sweeping the ndim true coordinates."""
    theta, lnl, kw = _case(case)
    want = jx.evidence_fn(theta, lnl, precision="device", engine="xla", **kw)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = pt.evidence_fn(theta, lnl, precision="device", device="cpu",
                             engine="pallas_smalld", **kw)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL_REF)
    if case == "lattice_retry":
        assert any("re-running with 24 extra candidates" in r.getMessage()
                   for r in caplog.records)


@pytest.mark.parametrize("case", ["auto", "cross", "lattice_retry"])
def test_smalld_refine_matches_reference(case):
    theta, lnl, kw = _case(case)
    want = jx.evidence_fn(theta, lnl, engine="xla", **kw)
    got = pt.evidence_fn(theta, lnl, device="cpu", engine="pallas_smalld",
                         **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)


def test_smalld_grid_device_refine_matches_reference():
    chains, _ = _grid_chains()
    kw = dict(kmax=3, prior_volumes=[1.0, 0.5, 2.0])
    got = ring.sharded_grid_device_refine_evidence(
        chains, device="cpu", engine="pallas_smalld", **kw)
    want = jax_ring.sharded_grid_device_refine_evidence(chains, engine="xla",
                                                        **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX_GRID)


def _grid_chains(cross=False):
    sizes = [(700, 3), (520, 4), (610, 5)]
    chains, refs = [], []
    for i, (n, d) in enumerate(sizes):
        th, ll = _chain(40 + i, n=n, ndim=d)
        w = np.random.default_rng(50 + i).integers(1, 4, n).astype(float)
        if cross:
            chains.append((th[: n // 2], ll[: n // 2], w[: n // 2]))
            refs.append(th[n // 2:])
        else:
            chains.append((th, ll, w))
    return chains, (refs if cross else None)


@pytest.mark.parametrize("cross", [False, True])
def test_grid_device_refine_matches_per_chain_and_reference(cross):
    chains, refs = _grid_chains(cross)
    pv = [1.0, 0.5, 2.0]
    sumw = [float(np.sum(c[2])) * 0.9 for c in chains]
    kw = dict(kmax=3, prior_volumes=pv, sum_adjusted_weights=sumw,
              chains2=refs)
    got = ring.sharded_grid_device_refine_evidence(chains, device="cpu",
                                                   **kw)
    fin = ring.sharded_grid_device_refine_evidence(chains, device="cpu",
                                                   defer=True, **kw)
    np.testing.assert_array_equal(fin(), got)
    want = jax_ring.sharded_grid_device_refine_evidence(chains, engine="xla",
                                                        **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX_GRID)
    for i, (s, lnl, w) in enumerate(chains):
        one = dict(samples2=refs[i] if cross else None, kmax=3,
                   prior_volume=pv[i], sum_adjusted_weights=sumw[i])
        np.testing.assert_allclose(
            got[i], jax_pipeline.device_refine_evidence(s, lnl, w,
                                                        engine="xla", **one),
            rtol=0, atol=ATOL_REF)
        np.testing.assert_allclose(
            got[i], pipeline.device_refine_evidence(s, lnl, w, device="cpu",
                                                    **one),
            rtol=0, atol=1e-12)


def test_grid_device_refine_retries_thin_margins(caplog):
    lat, ll = _lattice()
    chains = [(lat, ll), (lat[:400], ll[:400])]
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu_torch"):
        got = ring.sharded_grid_device_refine_evidence(chains, kmax=2,
                                                       device="cpu")
    assert any("grid device-refine: thin margins" in r.getMessage()
               for r in caplog.records)
    want = jax_ring.sharded_grid_device_refine_evidence(chains, kmax=2,
                                                        engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX_GRID)
    for i, (s, lnl) in enumerate(chains):
        np.testing.assert_allclose(
            got[i], jax_pipeline.host_refine_evidence(s, lnl, kmax=2,
                                                      engine="xla"),
            rtol=0, atol=ATOL_REF)


@pytest.mark.parametrize("cross", [False, True])
def test_grid_refine_matches_reference(cross):
    chains, refs = _grid_chains(cross)
    kw = dict(kmax=3, prior_volumes=[1.0, 0.5, 2.0], chains2=refs)
    got = ring.sharded_grid_evidence_refine(chains, device="cpu", **kw)
    want = jax_ring.sharded_grid_evidence_refine(chains, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)


def test_fused_batch_matches_per_cell():
    import torch
    preps = [pipeline._device_refine_prepare(*_chain(60 + i, n=n, ndim=3),
                                             None, 3, 4, device="cpu")
             for i, n in enumerate((500, 340, 410))]
    per_cell = [pipeline.fused_refine_dotp(
        t["q64"], t["r64"], t["scal"], h["n_ref"], h["ndim"], h["inv_s2"],
        k_sel=h["k_sel"], kmax=3) for t, h in preps]
    rows = max(h["n"] for _, h in preps)
    q = torch.zeros((3, rows, 3), dtype=torch.float64)
    scal = torch.zeros((3, rows), dtype=torch.float64)
    for b, (t, h) in enumerate(preps):
        q[b, :h["n"]] = t["q64"]
        scal[b, :h["n"]] = t["scal"]
    batch = pipeline.fused_refine_dotp_batch(
        q, q, scal, [h["n"] for _, h in preps], [h["n"] for _, h in preps],
        [3] * 3, [h["inv_s2"] for _, h in preps], k_sel=7, kmax=3)
    for b, flat in enumerate(per_cell):
        torch.testing.assert_close(batch[b], flat, rtol=1e-14, atol=0)
