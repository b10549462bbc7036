"""The port's evidence API against the JAX package and the sklearn oracle.

Both packages get the same chains (seeded numpy) and run the refine path:
the JAX package through its plain XLA selection, the port through its plain
PyTorch selection on ``device="cpu"``.  Both refine the candidates and
evaluate the estimator in f64, so they agree to 1e-9; the sklearn oracle of
tests/test_evidence.py holds both to 1e-6.
"""

import numpy as np
import pytest
import torch

import mcevidence_tpu as jx
import mcevidence_tpu_torch as pt
from tests.conftest import make_gaussian_chain
from tests.test_evidence import oracle_auto_evidence

ATOL_REF = 1e-9
ATOL_ORACLE = 1e-6


def _chain(seed, n=1500, ndim=4):
    return make_gaussian_chain(np.random.default_rng(seed), n=n, ndim=ndim)


@pytest.mark.parametrize("case", ["auto", "cross", "weights",
                                  "cross_single_cov", "no_prewhiten"])
def test_evidence_fn_matches_reference(case):
    theta, lnl = _chain(1)
    kw = {"kmax": 4}
    if case.startswith("cross"):
        half = len(theta) // 2
        theta, lnl, kw["samples2"] = theta[:half], lnl[:half], theta[half:]
    if case == "cross_single_cov":
        kw["covtype"] = "single"
    if case == "weights":
        kw["weights"] = np.random.default_rng(2).integers(
            1, 5, len(theta)).astype(float)
    if case == "no_prewhiten":
        kw["prewhiten"] = False
    want = jx.evidence_fn(theta, lnl, engine="xla", **kw)
    got = pt.evidence_fn(theta, lnl, device="cpu", **kw)
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)


@pytest.mark.parametrize("weighted", [False, True])
def test_evidence_fn_matches_sklearn_oracle(weighted):
    theta, lnl = _chain(3, n=1200, ndim=3)
    w = (np.random.default_rng(4).integers(1, 5, len(theta)).astype(float)
         if weighted else np.ones(len(theta)))
    got = pt.evidence_fn(theta, lnl, weights=w, kmax=4, device="cpu")
    np.testing.assert_allclose(got, oracle_auto_evidence(theta, lnl, w, 4),
                               rtol=0, atol=ATOL_ORACLE)


@pytest.fixture
def cosmomc_root(tmp_path):
    rng = np.random.default_rng(8)
    for c in (1, 2, 3):
        theta, lnl = make_gaussian_chain(rng, n=500, ndim=3)
        w = rng.integers(1, 4, len(theta)).astype(float)
        np.savetxt(tmp_path / f"ch_{c}.txt", np.column_stack([w, -lnl, theta]))
    return str(tmp_path / "ch")


FACADE_CASES = {
    "default": ({}, {}),
    "split_seed": ({"split": True, "seed": 3}, {}),
    "split_single_cov": ({"split": True, "seed": 4}, {"covtype": None}),
    "importance": ({"isfunc": lambda s: 0.2 * s[:, 0] ** 2}, {}),
    "brange_batches": ({"nbatch": 2, "brange": [2.5, 3.0],
                        "bscale": "logpower", "burnlen": 0.1}, {}),
    "poisson_thin": ({"thinlen": 0.5, "seed": 6}, {"info": True}),
    "rand_batches": ({"nbatch": 2, "brange": [300, 600],
                      "bscale": "linear", "seed": 9}, {"rand": True}),
}


@pytest.mark.parametrize("case", sorted(FACADE_CASES))
def test_mcevidence_matches_reference(case, cosmomc_root):
    init, call = FACADE_CASES[case]
    want = jx.MCEvidence(cosmomc_root, kmax=3, verbose=0, engine="xla",
                         **init).evidence(**call)
    got = pt.MCEvidence(cosmomc_root, kmax=3, verbose=0, device="cpu",
                        **init).evidence(**call)
    if call.get("info"):
        assert got[1] == want[1]
        got, want = got[0], want[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)


def test_evidence_with_error_matches_reference(cosmomc_root):
    want = jx.evidence_with_error(cosmomc_root, kmax=3, engine="xla",
                                  burnlen=0.1)
    got = pt.evidence_with_error(cosmomc_root, kmax=3, device="cpu",
                                 burnlen=0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_REF)


@pytest.mark.parametrize("split", [False, True])
def test_evidence_bootstrap_matches_reference(cosmomc_root, split):
    want = jx.evidence_bootstrap(cosmomc_root, kmax=3, n_boot=20, seed=5,
                                 engine="xla", split=split)
    got = pt.evidence_bootstrap(cosmomc_root, kmax=3, n_boot=20, seed=5,
                                device="cpu", split=split)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_REF)


def test_device_precision_now_runs():
    theta, lnl = _chain(5, n=200)
    want = jx.evidence_fn(theta, lnl, precision="device", engine="xla")
    got = pt.evidence_fn(theta, lnl, precision="device", device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)
    mce = pt.MCEvidence({"samples": theta, "loglikes": lnl},
                        precision="device", device="cpu", verbose=0)
    np.testing.assert_allclose(mce.evidence(), want, rtol=0, atol=ATOL_REF)
    assert "fused_s" in mce.timings


def test_fast_precision_now_runs():
    theta, lnl = _chain(5, n=200)
    want = jx.evidence_fn(theta, lnl, precision="fast", engine="xla")
    got = pt.evidence_fn(theta, lnl, precision="fast", device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mce = pt.MCEvidence({"samples": theta, "loglikes": lnl},
                        precision="fast", device="cpu", verbose=0)
    np.testing.assert_allclose(
        mce.evidence(),
        jx.MCEvidence({"samples": theta, "loglikes": lnl}, precision="fast",
                      engine="xla", verbose=0).evidence(),
        rtol=0, atol=1e-4)
    assert "fused_s" in mce.timings


def test_unknown_precision_raises():
    theta, lnl = _chain(5, n=200)
    with pytest.raises(ValueError, match="unknown precision"):
        pt.evidence_fn(theta, lnl, precision="exact", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        pt.MCEvidence({"samples": theta, "loglikes": lnl},
                      precision="exact", device="cpu", verbose=0)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    theta, lnl = _chain(6, n=200)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pt.evidence_fn(theta, lnl)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pt.MCEvidence({"samples": theta, "loglikes": lnl}, verbose=0)
