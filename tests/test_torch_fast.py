"""The port's ``fast`` precision against the JAX package's.

The same seeded numpy chains go through ``mcevidence_tpu``'s fast path
(``precision="fast", engine="xla"``) and the port's (``device="cpu"``,
where the kernel wrappers take their plain version).  Both sides work in
f32, but not alike: JAX's selection takes d2 by the matrix-product identity,
the port's by differences, and the sums run in other orders, so they are
held to each other at ``ATOL_JAX`` = 1e-4 in ln Z.  The port's fast path is
held to its refine path at the reference's own gate, 3e-3
(tests/test_evidence.py:169-176), and the importance shift at 1e-5
(:179-187).

One property of the reference bounds the grid comparisons: the JAX grid
program (``parallel/ring.py:sharded_grid_auto_evidence``) takes f32 moments
and distances of uncentred chains, which costs it ~6e-4 in ln Z on chains
~20-40 sigma from the origin; the port centres each chain in f64 first.  So
the port's grid is held to the JAX program on pre-centred chains (the same
function) and, through the driver, to JAX's per-cell fast tables (which
centre too), both at ``ATOL_JAX``.
"""

import contextlib
import io
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
import mcevidence_tpu as jx
import mcevidence_tpu_torch as pt
from mcevidence_tpu import cli as jax_cli
from mcevidence_tpu import planck as jax_planck
from mcevidence_tpu.ops import estimator as jax_estimator
from mcevidence_tpu.ops import pipeline as jax_pipeline
from mcevidence_tpu.ops import whiten as jax_whiten
from mcevidence_tpu.parallel import ring as jax_ring
from mcevidence_tpu_torch import cli as port_cli
from mcevidence_tpu_torch import planck
from mcevidence_tpu_torch.ops import estimator, pipeline, whiten
from mcevidence_tpu_torch.ops import knn_hopper as kh
from mcevidence_tpu_torch.parallel import ring
from tests.conftest import make_gaussian_chain
from tests.test_planck import _write_chain
from tests.test_torch_cli import _lnb_lines, toy_root  # noqa: F401

ATOL_JAX = 1e-4
ATOL_REFINE = 3e-3
DS = "plikHM_TT_lowTEB"


def _chain(seed, n=1500, ndim=4):
    return make_gaussian_chain(np.random.default_rng(seed), n=n, ndim=ndim)


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# --- the modules: whitening and the estimator --------------------------------

def _pairwise(x):
    x = np.asarray(x, np.float64)
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))


@pytest.mark.parametrize("case", ["posdef", "masked", "singular"])
def test_whiten_masked_matches_reference(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 4)) @ rng.normal(size=(4, 4))
    x = (x - x.mean(0)).astype(np.float32)
    valid = np.ones(300, np.float32)
    if case == "masked":
        valid[250:] = 0.0
        x[250:] = 1e3            # padding rows stay out of the moments
    if case == "singular":
        x[:, 3] = x[:, 2]
    want_w, want_j, want_pd = (np.asarray(a) for a in
                               jax_whiten.whiten_masked_jnp(
                                   jnp.asarray(x), jnp.asarray(valid)))
    got_w, got_j, got_pd = (t.numpy() for t in whiten.whiten_masked(
        _f32(x), _f32(valid)))
    assert bool(got_pd) == bool(want_pd) == (case != "singular")
    np.testing.assert_allclose(got_j, want_j, rtol=0, atol=1e-5)
    # eigenvector signs differ between frameworks: compare distances
    n = 250 if case == "masked" else 300
    np.testing.assert_allclose(_pairwise(got_w[:n]), _pairwise(want_w[:n]),
                               rtol=1e-4, atol=1e-4)


def test_whiten_masked_batched_is_per_member():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 200, 3)).astype(np.float32)
    valid = np.ones((3, 200), np.float32)
    valid[1, 150:] = 0.0
    valid[2, 40:] = 0.0
    white, log_j, posdef = whiten.whiten_masked(_f32(x), _f32(valid))
    for b in range(3):
        one = whiten.whiten_masked(_f32(x[b]), _f32(valid[b]))
        torch.testing.assert_close(white[b], one[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(log_j[b], one[1], rtol=1e-6, atol=1e-6)
        assert bool(posdef[b]) and bool(one[2])


@pytest.mark.parametrize("case", ["auto_squared", "cross", "masked",
                                  "zero_distances"])
def test_estimator_matches_reference(case):
    rng = np.random.default_rng(6)
    n, k = 400, 5
    d2 = np.sort(rng.exponential(size=(n, k)), axis=1).astype(np.float32)
    lnl = rng.normal(size=n).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    kw = dict(ndim=4, log_jacobian=0.3, log_prior_volume=-1.2,
              k_start=0 if case == "cross" else 1, squared=True)
    valid = None
    if case == "masked":
        valid = (np.arange(n) < 300).astype(np.float32)
        lnl[300:] = -1e30
    if case == "zero_distances":
        d2[:, :2] = 0.0
    if case == "cross":
        kw["squared"] = False
    sumw = float(np.sum(w if valid is None else w * valid))
    want = np.asarray(jax_estimator.log_evidence_from_knn(
        jnp.asarray(d2), jnp.asarray(lnl), jnp.asarray(w), sumw,
        nsamples=300 if valid is not None else None,
        valid=None if valid is None else jnp.asarray(valid), **kw))
    got = estimator.log_evidence_from_knn(
        _f32(d2), _f32(lnl), _f32(w), sumw,
        nsamples=300 if valid is not None else None,
        valid=None if valid is None else _f32(valid), **kw).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)
    if case == "zero_distances":
        assert np.isneginf(got[kw["k_start"]:2]).all()


def test_estimator_batched_is_per_member():
    rng = np.random.default_rng(7)
    d2 = np.sort(rng.exponential(size=(2, 100, 4)), axis=2).astype(
        np.float32)
    lnl = rng.normal(size=(2, 100)).astype(np.float32)
    w = np.ones((2, 100), np.float32)
    valid = np.ones((2, 100), np.float32)
    valid[1, 70:] = 0
    got = estimator.log_evidence_from_knn(
        _f32(d2), _f32(lnl), _f32(w), _f32([100.0, 70.0]), 3,
        log_jacobian=_f32([0.1, -0.2]), log_prior_volume=_f32([0.0, 0.5]),
        k_start=1, nsamples=_f32([100, 70]), valid=_f32(valid), squared=True)
    for b, (sumw, lj, lpv, n) in enumerate([(100.0, 0.1, 0.0, 100),
                                            (70.0, -0.2, 0.5, 70)]):
        one = estimator.log_evidence_from_knn(
            _f32(d2[b, :n]), _f32(lnl[b, :n]), _f32(w[b, :n]), sumw, 3,
            log_jacobian=lj, log_prior_volume=lpv, k_start=1, squared=True)
        torch.testing.assert_close(got[b], one, rtol=0, atol=2e-6)


def test_fused_auto_evidence_matches_reference():
    theta, lnl = _chain(9, n=800, ndim=3)
    s = (theta - theta.mean(0)).astype(np.float32)
    n = len(s)
    want = np.asarray(jax_pipeline.fused_auto_evidence(
        jnp.asarray(s), jnp.asarray(lnl, jnp.float32),
        jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32),
        jnp.asarray(n, jnp.int32), jnp.float32(0.4), kmax=6, ndim=3,
        engine="xla"))
    got = pipeline.fused_auto_evidence(
        _f32(s), _f32(lnl), torch.ones(n), torch.tensor(0.4), kmax=6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_JAX)


# --- the entry points ---------------------------------------------------------

def _case(name):
    theta, lnl = _chain(1)
    kw = {"kmax": 4}
    if name == "cross":
        return theta[:750], lnl[:750], dict(kw, samples2=theta[750:])
    if name == "weights":
        w = np.random.default_rng(2).integers(1, 5, len(theta)).astype(float)
        return theta, lnl, dict(kw, weights=w)
    if name == "kmax20":
        return theta, lnl, {"kmax": 20}
    if name == "no_prewhiten":
        return theta, lnl, dict(kw, prewhiten=False)
    return theta, lnl, kw


@pytest.mark.parametrize("case", ["auto", "cross", "weights", "kmax20",
                                  "no_prewhiten"])
def test_evidence_fn_fast_matches_reference(case):
    theta, lnl, kw = _case(case)
    want = jx.evidence_fn(theta, lnl, precision="fast", engine="xla", **kw)
    got = pt.evidence_fn(theta, lnl, precision="fast", device="cpu", **kw)
    assert got.shape == want.shape == (kw["kmax"] - 1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)


@pytest.mark.parametrize("case", ["auto", "cross", "kmax20"])
def test_evidence_fn_fast_within_gate_of_refine(case):
    theta, lnl, kw = _case(case)
    fast = pt.evidence_fn(theta, lnl, precision="fast", device="cpu", **kw)
    ref = pt.evidence_fn(theta, lnl, precision="refine", device="cpu", **kw)
    np.testing.assert_allclose(fast, ref, rtol=0, atol=ATOL_REFINE)


def test_fast_engines_agree():
    """pallas_exact and pallas_smalld both take the exact dispatch when the
    distances are used directly (knn.py:343-345)."""
    theta, lnl, kw = _case("auto")
    base = pt.evidence_fn(theta, lnl, precision="fast", device="cpu", **kw)
    for engine in ("pallas_exact", "pallas_smalld", "torch"):
        np.testing.assert_array_equal(
            pt.evidence_fn(theta, lnl, precision="fast", engine=engine,
                           device="cpu", **kw), base)


@pytest.fixture
def cosmomc_root(tmp_path):
    rng = np.random.default_rng(8)
    for c in (1, 2, 3):
        theta, lnl = make_gaussian_chain(rng, n=500, ndim=3)
        w = rng.integers(1, 4, len(theta)).astype(float)
        np.savetxt(tmp_path / f"ch_{c}.txt", np.column_stack([w, -lnl, theta]))
    return str(tmp_path / "ch")


FACADE_CASES = {
    "fused": ({}, {}),
    "fused_importance": ({"isfunc": lambda s: 0.2 * s[:, 0] ** 2}, {}),
    "split_batch_loop": ({"split": True, "seed": 3}, {}),
    "brange_batch_loop": ({"nbatch": 2, "brange": [2.5, 3.0],
                           "bscale": "logpower", "burnlen": 0.1}, {}),
    "no_prewhiten_batch_loop": ({}, {"prewhiten": False}),
}


@pytest.mark.parametrize("case", sorted(FACADE_CASES))
def test_mcevidence_fast_matches_reference(case, cosmomc_root):
    init, call = FACADE_CASES[case]
    want = jx.MCEvidence(cosmomc_root, kmax=3, verbose=0, engine="xla",
                         precision="fast", **init).evidence(**call)
    mce = pt.MCEvidence(cosmomc_root, kmax=3, verbose=0, device="cpu",
                        precision="fast", **init)
    got = mce.evidence(**call)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    assert ("fused_s" in mce.timings) == case.startswith("fused")


def test_mcevidence_fast_within_gate_of_refine(cosmomc_root):
    fast = pt.MCEvidence(cosmomc_root, kmax=3, verbose=0, device="cpu",
                         precision="fast").evidence()
    ref = pt.MCEvidence(cosmomc_root, kmax=3, verbose=0,
                        device="cpu").evidence()
    np.testing.assert_allclose(fast, ref, rtol=0, atol=ATOL_REFINE)


def test_fast_importance_shift():
    """tests/test_evidence.py:179-187: a constant importance weight shifts
    ln Z by exactly -c through SumW alone."""
    theta, lnl = _chain(12, n=1200, ndim=3)
    chain = {"samples": theta, "loglikes": lnl}
    c = 0.4
    base = pt.MCEvidence(chain, kmax=2, verbose=0, device="cpu",
                         precision="fast").evidence()
    rew = pt.MCEvidence(chain, kmax=2, verbose=0, device="cpu",
                        isfunc=lambda s: np.full(len(s), c),
                        precision="fast").evidence()
    np.testing.assert_allclose(rew - base, -c, atol=1e-5)


def test_fast_kmax_beyond_n_marks_nan():
    """tests/test_evidence.py:620-636: columns k >= n have no k-th
    neighbour and come back NaN; the others match the host path."""
    rng = np.random.default_rng(13)
    s = rng.normal(size=(3, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    fast = pipeline.fast_auto_evidence(s, lnl, kmax=5, device="cpu")
    want = jax_pipeline.fast_auto_evidence(s, lnl, kmax=5, engine="xla")
    assert fast.shape == (4,)
    assert np.isfinite(fast[:2]).all() and np.isnan(fast[2:]).all()
    np.testing.assert_array_equal(np.isnan(fast), np.isnan(np.asarray(want)))
    np.testing.assert_allclose(fast[:2], np.asarray(want)[:2], atol=ATOL_JAX)
    host = pipeline.host_refine_evidence(s, lnl, kmax=5, device="cpu")
    np.testing.assert_allclose(fast[:2], host[:2], atol=5e-4)


@pytest.mark.parametrize("split", [False, True])
def test_evidence_bootstrap_fast_matches_reference(cosmomc_root, split):
    want = jx.evidence_bootstrap(cosmomc_root, kmax=3, n_boot=20, seed=5,
                                 engine="xla", split=split, precision="fast")
    got = pt.evidence_bootstrap(cosmomc_root, kmax=3, n_boot=20, seed=5,
                                device="cpu", split=split, precision="fast")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_JAX)


def test_evidence_with_error_fast_matches_reference(cosmomc_root):
    want = jx.evidence_with_error(cosmomc_root, kmax=3, engine="xla",
                                  precision="fast")
    got = pt.evidence_with_error(cosmomc_root, kmax=3, device="cpu",
                                 precision="fast")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_JAX)


@pytest.mark.parametrize("args", [
    ["-k", "3"],
    ["-k", "4", "--cross", "--seed", "1"],
    ["-k", "3", "--bootstrap", "8", "--seed", "3", "--error"],
], ids=["auto", "cross", "bootstrap_error"])
def test_cli_fast_matches_reference(toy_root, capsys, args):  # noqa: F811
    args = args + ["-vb", "0", "--precision", "fast"]
    assert jax_cli.main([toy_root, "--engine", "xla"] + args) == 0
    want = _lnb_lines(capsys.readouterr().out)
    assert port_cli.main([toy_root, "--device", "cpu"] + args) == 0
    got = _lnb_lines(capsys.readouterr().out)
    assert want and got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=ATOL_JAX)


# --- the grid -----------------------------------------------------------------

def _grid_chains(seed=40, sizes=((700, 4), (520, 4), (610, 4))):
    chains = []
    for i, (n, d) in enumerate(sizes):
        th, ll = _chain(seed + i, n=n, ndim=d)
        w = np.random.default_rng(seed + 10 + i).integers(1, 4, n).astype(
            float)
        chains.append((th, ll, w))
    return chains


def test_grid_fast_matches_reference_program():
    chains = _grid_chains()
    kw = dict(kmax=4, prior_volumes=[1.0, 0.5, 2.0],
              sumw_log_shifts=[0.0, 0.1, -0.2])
    kh.reset_launch_counts()
    got = ring.sharded_grid_auto_evidence(chains, device="cpu", **kw)
    assert got.shape == (3, 3) and np.isfinite(got).all()
    assert kh.knn_select_batched.launches == 0
    centred = [(s - s.mean(0), l, w) for s, l, w in chains]
    want = jax_ring.sharded_grid_auto_evidence(centred, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    # the property of the reference that the centring avoids: its program
    # on the raw chains (20-80 sigma from the origin) misses by more
    raw = jax_ring.sharded_grid_auto_evidence(chains, **kw)
    assert np.max(np.abs(raw - got)) > 3 * ATOL_JAX
    for i, (s, lnl, w) in enumerate(chains):
        one = pipeline.fast_auto_evidence(
            s, lnl, w, kmax=4, prior_volume=kw["prior_volumes"][i],
            sum_adjusted_weights=float(np.sum(w)
                                       * np.exp(kw["sumw_log_shifts"][i])),
            device="cpu")
        np.testing.assert_allclose(got[i], one, rtol=0, atol=ATOL_JAX)


def test_grid_fast_offset_chain_stays_within_gate_of_refine():
    """A chain ~1e3 sigma from the origin: the host f64 centring keeps the
    f32 moments and selection exact enough for the fast gate."""
    rng = np.random.default_rng(31)
    mean = np.array([0.0222, 0.12, 1.041])
    sig = np.array([0.0002, 0.002, 0.0005])
    chains = []
    for n in (1500, 1200):
        theta = rng.normal(mean, sig, size=(n, 3))
        dm = (theta - mean) / sig
        chains.append((theta, -0.5 * np.sum(dm * dm, axis=1)))
    got = ring.sharded_grid_auto_evidence(chains, kmax=3, device="cpu")
    for i, (s, lnl) in enumerate(chains):
        ref = pt.evidence_fn(s, lnl, kmax=3, device="cpu")
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=ATOL_REFINE)


def test_grid_fast_takes_one_ndim_per_batch():
    chains = _grid_chains(sizes=((300, 3), (300, 4)))
    with pytest.raises(ValueError, match="one dimensionality"):
        ring.sharded_grid_auto_evidence(chains, device="cpu")


@pytest.fixture(scope="module")
def fastgrid(tmp_path_factory):
    root = tmp_path_factory.mktemp("fastgrid")
    rng = np.random.default_rng(12345)
    for model, ndim in [("base", 4), ("base_w", 5)]:
        d = root / model / DS
        d.mkdir(parents=True)
        _write_chain(str(d / f"{model}_{DS}"), rng, ndim)
    return str(root)


def _same_table(got, want, atol):
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    for col in ("PriorVol", "ndim", "N_read", "N_used"):
        assert list(got[col]) == list(want[col]), col
    lnz = [c for c in want.columns
           if c not in ("PriorVol", "ndim", "N_read", "N_used")]
    np.testing.assert_allclose(got[lnz].to_numpy(float),
                               want[lnz].to_numpy(float), rtol=0, atol=atol)


@pytest.mark.parametrize("nchain", [0, 2], ids=["allchains", "nc2"])
def test_grid_driver_fast_matches_reference(fastgrid, nchain):
    kw = dict(kmax=3, verbose=0, nchain=nchain, precision="fast")
    got = planck.dataset_evidence(fastgrid, DS, device="cpu",
                                  batch_cells=True, **kw)
    # JAX's per-cell fast path (MCEvidence, which centres like the port)
    want = jax_planck.dataset_evidence(fastgrid, DS, engine="xla",
                                       batch_cells=False, **kw)
    _same_table(got, want, ATOL_JAX)
    per_cell = planck.dataset_evidence(fastgrid, DS, device="cpu",
                                       batch_cells=False, **kw)
    _same_table(per_cell, want, ATOL_JAX)
    refine = planck.dataset_evidence(fastgrid, DS, device="cpu",
                                     batch_cells=False,
                                     **dict(kw, precision="refine"))
    _same_table(got, refine, ATOL_REFINE)


def test_grid_driver_fast_cross_runs_refine(fastgrid, caplog):
    import logging
    kw = dict(kmax=2, verbose=0, cross=True, seed=11)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu_torch.planck"):
        got = planck.dataset_evidence(fastgrid, DS, device="cpu",
                                      batch_cells=True, precision="fast",
                                      **kw)
    assert any("batched cross-evidence runs on the refine path"
               in r.getMessage() for r in caplog.records)
    want = jax_planck.dataset_evidence(fastgrid, DS, engine="xla",
                                       batch_cells=True, precision="fast",
                                       **kw)
    _same_table(got, want, 1e-9)


def test_grid_main_fast(fastgrid, tmp_path):
    out = str(tmp_path / "port")
    with contextlib.redirect_stdout(io.StringIO()):
        assert planck.main(["--rootdir", fastgrid, "-o", out, "-v", "0",
                            "--device", "cpu", "--precision", "fast",
                            "-nc", "2"]) == 0
    table = pd.read_csv(os.path.join(out, "SingleChains", "csv",
                                     f"mce_{DS}.csv"), index_col=0)
    want = jax_planck.dataset_evidence(fastgrid, DS, engine="xla", kmax=2,
                                       nchain=2, precision="fast",
                                       verbose=0)
    lnz = [c for c in want.columns if c.startswith("chain")]
    np.testing.assert_allclose(table[lnz].to_numpy(float),
                               want[lnz].to_numpy(float), rtol=0,
                               atol=ATOL_JAX)
