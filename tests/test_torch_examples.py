"""The port's validation examples against ``mcevidence_tpu.examples``.

The model classes are the same numpy code in both packages: from the same
``np.random.Generator`` every array they draw is bit-identical, and so are
the nested run's written products.  tests/test_examples.py's asserts run on
the port with the same tolerances, on ``device="cpu"``; wherever that file
estimates ln Z, the port's estimate on the same chain is also held to the
JAX package's (``engine="xla"``) at 1e-6.  ``glm_nuts`` takes its gradients
in f64 on the port and in f32 in JAX, so its chain is held to the GLM's
posterior, not to JAX's draws.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import mcevidence_tpu as jx
import mcevidence_tpu_torch as pt
from mcevidence_tpu import examples as jex
from mcevidence_tpu_torch import examples as pex

ATOL_REF = 1e-6
_DEFAULT_RNG = np.random.default_rng


def pin_default_rng(monkeypatch, seed):
    """``np.random.default_rng()`` without a seed returns generators seeded
    ``seed``, ``seed + 1``, ... in call order, so two runs that draw from
    unseeded generators in the same order draw the same numbers."""
    seeds = iter(range(seed, seed + 1000))

    def default_rng(s=None):
        return _DEFAULT_RNG(next(seeds) if s is None else s)
    monkeypatch.setattr(np.random, "default_rng", default_rng)


def assert_same_lnz(chain, **kw):
    """The port's ``MCEvidence`` on ``device="cpu"`` and JAX's on
    ``engine="xla"``, on the same chain: returns the port's."""
    got = pt.MCEvidence(chain, verbose=0, device="cpu", **kw).evidence()
    want = jx.MCEvidence(chain, verbose=0, engine="xla", **kw).evidence()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)
    return got


# --- tests/test_examples.py's asserts, on the port ------------------------

def test_glm_gibbs_analytic_evidence(rng):
    model = pex.glm_eg(verbose=0, rng=rng)
    samples, lnl = model.Sampler(nsamples=4000)
    mle = assert_same_lnz({"samples": samples, "loglikes": lnl},
                          burnlen=0.1, kmax=2,
                          priorvolume=float(model.ptheta.prod()))
    truth = model.evidence()
    assert abs(mle[0] - truth) < 0.3, (mle, truth)


def test_gaussian_eg_sampler_normalized(rng):
    model = pex.gaussian_eg(ndim=6, verbose=0, rng=rng)
    samples, lnl = model.Sampler(nsamples=4000)
    mle = assert_same_lnz({"samples": samples, "loglikes": lnl}, kmax=2)
    assert abs(mle[0]) < 0.2


def test_gaussian_eg_lnprob_consistency(rng):
    model = pex.gaussian_eg(ndim=4, ndata=5000, verbose=0, rng=rng)
    samples, lnl = model.Sampler(nsamples=10)
    for i in range(10):
        assert np.isclose(lnl[i], model.lnprob(samples[i]))


def test_model_2d_prior_bounds(rng):
    m = pex.model_2d(rng=rng)
    assert m.lnprob(np.array([-0.9594, 4.294])) > -np.inf
    assert m.lnprior(np.array([1e6, 0.0])) == -np.inf
    pos = m.pos(100)
    assert pos.shape == (100, 2)
    assert np.isfinite([m.lnprob(p) for p in pos]).all()


def test_model_2d_vis(rng, tmp_path):
    m = pex.model_2d(rng=rng)
    out = str(tmp_path / "corner.png")
    fig = m.vis(m.pos(200), fname=out)
    assert fig is not None and os.path.getsize(out) > 0


def test_glm_evidence_formula_selfconsistent(rng):
    m = pex.glm_eg(verbose=0, rng=rng)
    z1 = m.evidence()
    m.ptheta = m.ptheta * 2
    z2 = m.evidence()
    assert np.isclose(z1 - z2, 3 * np.log(2.0))


def test_glm_nuts_analytic_evidence():
    nuts = pex.glm_nuts(seed=3, device="cpu")
    samples, lnl = nuts.Sampler(nsamples=2500)
    ml = nuts.model.theta_sample
    sig = np.sqrt(np.diag(np.linalg.inv(nuts.model.D.T @ nuts.model.D)))
    assert np.all(np.abs(samples.mean(axis=0) - ml) < 6 * sig)
    mle = assert_same_lnz({"samples": samples, "loglikes": lnl}, kmax=2,
                          priorvolume=float(nuts.ptheta.prod()))
    truth = nuts.evidence()
    assert abs(mle[0] - truth) < 0.3, (mle, truth)


def test_examples_main_runs(capsys):
    pex.main(["gaussian_eg", "1500", "--device", "cpu"])
    assert "estimated ln Z" in capsys.readouterr().out


def test_examples_main_nested_eg(capsys):
    pex.main(["nested_eg", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "nested run's own ln Z" in out
    assert "analytic ln Z" in out


def test_banana_quadrature_evidence(rng):
    m = pex.banana_eg(verbose=0, rng=rng)
    truth = m.evidence()
    assert abs(truth - (math.log(2 * math.pi * m.a * m.c)
                        - math.log(m.prior_volume))) < 1e-6
    theta, lnl = m.Sampler(16000)
    np.testing.assert_allclose(lnl[:50], m.lnlike(theta[:50]), rtol=1e-12)
    mle = assert_same_lnz({"samples": theta, "loglikes": lnl}, kmax=2,
                          ischain=True, priorvolume=m.prior_volume)
    assert abs(mle[0] - truth) < 0.2, (mle, truth)


def test_importance_weighted_chain_consistent(rng):
    d, n, c = 4, 16000, 1.5
    mean = np.linspace(1.0, 2.0, d)
    sig = np.full(d, 0.05)
    lognorm = -0.5 * d * math.log(2 * math.pi) - np.sum(np.log(sig))
    th = rng.normal(mean, c * sig, size=(n, d))
    zt = (th - mean) / sig
    lnl = -0.5 * np.sum(zt * zt, axis=1) + lognorm
    zq = (th - mean) / (c * sig)
    lnq = -0.5 * np.sum(zq * zq, axis=1) + lognorm - d * math.log(c)
    w = np.exp(lnl - lnq)
    lnz = pt.evidence_fn(th, lnl, w, kmax=2, device="cpu")
    np.testing.assert_allclose(
        lnz, jx.evidence_fn(th, lnl, w, kmax=2, engine="xla"), rtol=0,
        atol=ATOL_REF)
    assert abs(lnz[0]) < 0.15, lnz


def test_gaussian_corr_analytic_evidence(rng):
    m = pex.gaussian_corr_eg(ndim=6, verbose=0, rng=rng)
    theta, lnl = m.Sampler(8000)
    np.testing.assert_allclose(lnl[:50], m.lnprob(theta[:50]), rtol=1e-10)
    _, logdet = np.linalg.slogdet(m.cov)
    assert logdet < -20
    mle = assert_same_lnz({"samples": theta, "loglikes": lnl}, kmax=2,
                          ischain=True)
    assert abs(mle[0]) < 0.15, mle


# --- the same draws as JAX's classes --------------------------------------

def _draws(ex, name, seed):
    """Every array the model class ``name`` of module ``ex`` draws from
    ``np.random.default_rng(seed)``, in a fixed order of calls."""
    rng = np.random.default_rng(seed)
    if name == "glm_eg":
        m = ex.glm_eg(verbose=0, rng=rng)
        start = m.theta_sample.copy()
        return [m.y_sample, m.D, m.b, start, *m.Sampler(300),
                [m.evidence(), m.lnlike(start)]]
    if name == "gaussian_eg":
        m = ex.gaussian_eg(ndim=5, ndata=500, verbose=0, rng=rng)
        return [m.d2d, m.sigma_mean, *m.Sampler(200), m.pos(10),
                [m.lnprob(m.d2d[0])]]
    if name == "gaussian_corr_eg":
        m = ex.gaussian_corr_eg(ndim=4, verbose=0, rng=rng)
        return [m.cov, m.icov, *m.Sampler(200), m.pos(10),
                m.lnprob(m.pos(3))]
    if name == "banana_eg":
        m = ex.banana_eg(verbose=0, rng=rng)
        return [*m.Sampler(300), m.pos(10), [m.evidence()]]
    if name == "model_2d":
        m = ex.model_2d(rng=rng)
        return [m.x, m.y, m.yerr, m.pos(20), [m.lnprob(m.p)]]
    if name == "nested_eg":
        m = ex.nested_eg(ndim=3, nlive=80, verbose=0, rng=rng)
        return [*m.run(), *m.equal_weights(), m.ns_lnz()]
    if name == "make_emcee_chain":
        mec = ex.make_emcee_chain(ex.model_2d(rng=rng), nwalkers=16,
                                  nburn=20, seed=3)
        return [mec.state, *mec.Sampler(200), *mec.Sampler(50)]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["glm_eg", "gaussian_eg",
                                  "gaussian_corr_eg", "banana_eg", "model_2d",
                                  "nested_eg", "make_emcee_chain"])
def test_model_draws_bit_identical_to_reference(name):
    got, want = _draws(pex, name, 21), _draws(jex, name, 21)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("style", ["multinest", "ultranest"])
def test_nested_products_bit_identical_to_reference(tmp_path, style):
    roots = {}
    for label, ex in (("port", pex), ("jax", jex)):
        m = ex.nested_eg(ndim=2, nlive=100, verbose=0,
                         rng=np.random.default_rng(9))
        os.makedirs(tmp_path / label)
        roots[label] = m.write_products(str(tmp_path / label), style=style)
    files = {label: sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / label)
        for d, _, fs in os.walk(tmp_path / label) for f in fs)
        for label in roots}
    assert files["port"] == files["jax"] and files["port"]
    for rel in files["port"]:
        with open(tmp_path / "port" / rel, "rb") as a, \
                open(tmp_path / "jax" / rel, "rb") as b:
            assert a.read() == b.read(), rel


def _printed(out):
    """``main``'s printed lines, with the numbers of the estimate parsed."""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    est = [ln for ln in lines if ln.startswith("estimated ln Z")]
    assert len(est) == 1, out
    nums = [float(t) for t in re.findall(r"[-+]?\d+\.\d*(?:e[-+]?\d+)?",
                                         est[0].split(":", 1)[1])]
    return nums, [ln for ln in lines if ln not in est]


@pytest.mark.parametrize("argv", [["gaussian_eg", "1500"],
                                  ["gaussian_corr_eg", "1500"],
                                  ["banana_eg", "2000"], ["glm_eg", "1500"],
                                  ["nested_eg"]])
def test_main_matches_reference(monkeypatch, capsys, argv):
    """With the unseeded generators pinned, ``main`` prints JAX's lines: the
    estimated ln Z within 1e-6, every other line the same."""
    pin_default_rng(monkeypatch, 11)
    assert pex.main(argv + ["--device", "cpu"]) == 0
    got = _printed(capsys.readouterr().out)
    pin_default_rng(monkeypatch, 11)
    assert jex.main(argv) == 0
    want = _printed(capsys.readouterr().out)
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL_REF)
    assert got[1] == want[1]


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_examples_on_card(cuda_device):
    """glm_nuts with its gradients on the card, under the asserts of
    tests/test_examples.py, and gaussian_eg's estimate on the card within
    1e-6 of the CPU's."""
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    nuts = pex.glm_nuts(seed=3, device=cuda_device)
    samples, lnl = nuts.Sampler(nsamples=2500)
    ml = nuts.model.theta_sample
    sig = np.sqrt(np.diag(np.linalg.inv(nuts.model.D.T @ nuts.model.D)))
    assert np.all(np.abs(samples.mean(axis=0) - ml) < 6 * sig)
    mle = pt.MCEvidence({"samples": samples, "loglikes": lnl}, verbose=0,
                        priorvolume=float(nuts.ptheta.prod()), kmax=2,
                        device=cuda_device).evidence()
    assert abs(mle[0] - nuts.evidence()) < 0.3, mle
    model = pex.gaussian_eg(ndim=6, verbose=0, rng=np.random.default_rng(5))
    chain = dict(zip(("samples", "loglikes"), model.Sampler(nsamples=8000)))
    kh.reset_launch_counts()
    got = pt.MCEvidence(chain, verbose=0, kmax=2,
                        device=cuda_device).evidence()
    assert kh.knn_select_small_k.launches > 0
    want = pt.MCEvidence(chain, verbose=0, kmax=2, device="cpu").evidence()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)
    assert abs(got[0]) < 0.2
