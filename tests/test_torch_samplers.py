"""The port's samplers against ``mcevidence_tpu.samplers``.

The NUTS tree recursion and the stretch move are the same numpy code in both
packages, so fed the same (value, gradient) function and seed they make the
same draws bit for bit.  The gradients differ: JAX takes them in f32 (x64 is
never enabled in the JAX package), the port in f64 through
``torch.autograd``, so NUTS chains from the two are held to their target's
moments, as tests/test_samplers.py holds JAX's, and not draw for draw.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcevidence_tpu import samplers as jax_samplers
from mcevidence_tpu_torch import samplers
from mcevidence_tpu_torch.samplers import nuts_sample, stretch_sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gaussian_target(mean, sig):
    m, s = torch.as_tensor(mean), torch.as_tensor(sig)

    def lnprob(x):
        z = (x - m) / s
        return -0.5 * torch.dot(z, z)
    return lnprob


# --- tests/test_samplers.py's asserts, on the port ------------------------

def test_nuts_gaussian_moments():
    mean = np.array([1.0, -2.0])
    sig = np.array([0.5, 2.0])
    samples, lnp = nuts_sample(_gaussian_target(mean, sig), np.zeros(2), 3000,
                               warmup=400, seed=42, device="cpu")
    assert samples.shape == (3000, 2)
    np.testing.assert_allclose(samples.mean(axis=0), mean,
                               atol=5 * sig.max() / np.sqrt(500))
    np.testing.assert_allclose(samples.std(axis=0), sig, rtol=0.15)
    z = (samples[:50] - mean) / sig
    np.testing.assert_allclose(lnp[:50], -0.5 * np.sum(z * z, axis=1),
                               atol=1e-4)


def test_nuts_correlated_target():
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov))

    def lnprob(x):
        return -0.5 * x @ prec @ x

    samples, _ = nuts_sample(lnprob, np.array([3.0, -3.0]), 4000,
                             warmup=400, seed=7, device="cpu")
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.2)


def test_nuts_anisotropic_target():
    sig = np.array([0.01, 1.0, 10.0])
    mean = np.array([0.5, -1.0, 20.0])
    samples, _ = nuts_sample(_gaussian_target(mean, sig), mean + sig, 3000,
                             warmup=600, seed=11, device="cpu")
    z = np.abs(samples.mean(axis=0) - mean) / sig
    assert np.all(z < 6.0 / np.sqrt(400)), z
    np.testing.assert_allclose(samples.std(axis=0), sig, rtol=0.2)


def test_stretch_sampler_gaussian_moments():
    """The stretch move recovers the target's moments, and its chain and
    lnp are JAX's bit for bit."""
    rng = np.random.default_rng(0)
    mean = np.array([1.0, -2.0])
    sig = np.array([0.5, 2.0])

    def lnprob(t):
        return float(-0.5 * np.sum(((t - mean) / sig) ** 2))

    p0 = mean + sig * rng.standard_normal((40, 2))
    chain, lnp = stretch_sample(lnprob, p0, 400, seed=1)
    flat = chain[100:].reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), mean, atol=0.15)
    np.testing.assert_allclose(flat.std(axis=0), sig, rtol=0.15)
    assert lnp.shape == (400, 40)
    want_chain, want_lnp = jax_samplers.stretch_sample(lnprob, p0, 400,
                                                       seed=1)
    assert np.array_equal(chain, want_chain)
    assert np.array_equal(lnp, want_lnp)


def test_gaussian_emcee_leg_runs_without_emcee(monkeypatch):
    """The ensemble leg runs without emcee (native stretch fallback); with
    the unseeded generators pinned, the port's ln Z is JAX's."""
    from mcevidence_tpu import examples as jax_examples
    from mcevidence_tpu_torch.examples import gaussian_emcee
    from test_torch_examples import pin_default_rng
    pin_default_rng(monkeypatch, 3)
    mle = gaussian_emcee(nwalkers=64, nmcmc=40, kmax=2, device="cpu")
    assert np.isfinite(mle).all()
    assert abs(mle[0]) < 6.0
    pin_default_rng(monkeypatch, 3)
    want = jax_examples.gaussian_emcee(nwalkers=64, nmcmc=40, kmax=2)
    np.testing.assert_allclose(mle, want, rtol=0, atol=1e-6)


# --- the recursion, the gradients and the device rule ---------------------

def _numpy_vgrad(mean, sig):
    def f(x):
        z = (x - mean) / sig
        return float(-0.5 * z @ z), -z / sig
    return f


@pytest.mark.parametrize("adapt_mass", [True, False])
def test_nuts_recursion_bit_identical_to_reference(monkeypatch, adapt_mass):
    """One numpy (value, gradient) function injected into both packages'
    ``nuts_sample``: the tree recursion, dual averaging and mass adaptation
    give the same draws bit for bit."""
    mean = np.array([0.5, -1.0, 3.0])
    sig = np.array([0.1, 1.0, 4.0])
    f = _numpy_vgrad(mean, sig)
    monkeypatch.setattr(samplers, "_make_vgrad", lambda lnprob, device: f)
    monkeypatch.setattr(jax_samplers, "_make_vgrad", lambda lnprob: f)
    kw = dict(warmup=200, seed=5, adapt_mass=adapt_mass, max_depth=8)
    got = samplers.nuts_sample(None, mean + sig, 300, **kw)
    want = jax_samplers.nuts_sample(None, mean + sig, 300, **kw)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def _glm_like(rng):
    D = rng.normal(size=(40, 3))
    b = rng.normal(size=40)
    return D, b


def test_make_vgrad_matches_analytic_gradient():
    D, b = _glm_like(np.random.default_rng(1))
    Dt, bt = torch.as_tensor(D), torch.as_tensor(b)

    def lnprob(x):
        r = bt - Dt @ x
        return -0.5 * torch.dot(r, r)

    f = samplers._make_vgrad(lnprob, "cpu")
    for x in np.random.default_rng(2).normal(size=(5, 3)):
        v, g = f(x)
        r = b - D @ x
        assert g.dtype == np.float64 and g.shape == (3,)
        assert abs(v - (-0.5 * r @ r)) <= 1e-12 * max(1.0, abs(v))
        np.testing.assert_allclose(g, D.T @ r, rtol=0, atol=1e-12)


def test_make_vgrad_matches_jax_value_and_grad():
    """JAX evaluates in f32, the port in f64: within 1e-5 relative."""
    import jax.numpy as jnp
    D, b = _glm_like(np.random.default_rng(3))
    Dt, bt = torch.as_tensor(D), torch.as_tensor(b)
    Dj, bj = jnp.asarray(D), jnp.asarray(b)

    def lnprob_t(x):
        r = bt - Dt @ x
        return -0.5 * torch.dot(r, r)

    def lnprob_j(x):
        r = bj - Dj @ x
        return -0.5 * jnp.dot(r, r)

    f_t = samplers._make_vgrad(lnprob_t, "cpu")
    f_j = jax_samplers._make_vgrad(lnprob_j)
    for x in np.random.default_rng(4).normal(size=(5, 3)):
        (vt, gt), (vj, gj) = f_t(x), f_j(x)
        assert abs(vt - vj) <= 1e-5 * abs(vt)
        np.testing.assert_allclose(gj, gt, rtol=0,
                                   atol=1e-5 * np.abs(gt).max())


def test_cuda_without_a_card_raises(monkeypatch):
    """``device="cuda"`` never falls back to the CPU: ``nuts_sample``,
    ``glm_nuts``, ``examples.main`` and ``MCEvidence`` raise."""
    from mcevidence_tpu_torch import MCEvidence
    from mcevidence_tpu_torch.examples import glm_nuts, main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    match = "torch.cuda.is_available"
    with pytest.raises(RuntimeError, match=match):
        nuts_sample(_gaussian_target([0.0], [1.0]), np.zeros(1), 10)
    with pytest.raises(RuntimeError, match=match):
        glm_nuts(seed=0)
    with pytest.raises(RuntimeError, match=match):
        main(["gaussian_eg", "100"])
    with pytest.raises(RuntimeError, match=match):
        MCEvidence({"samples": np.zeros((10, 2)), "loglikes": np.zeros(10)},
                   verbose=0)


def test_samplers_and_examples_import_without_jax():
    code = ("import sys\n"
            "import mcevidence_tpu_torch as pt\n"
            "import mcevidence_tpu_torch.samplers\n"
            "import mcevidence_tpu_torch.examples\n"
            "assert pt.nuts_sample and pt.stretch_sample\n"
            "print('JAX', 'jax' in sys.modules,\n"
            "      any(m == 'mcevidence_tpu' or m.startswith('mcevidence_tpu.')\n"
            "          for m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX False False" in proc.stdout
