"""Validation examples: analytic-truth likelihoods + samplers.

The counterpart of ``mcevidence_tpu.examples``: the model classes are the
same numpy code, so from the same ``np.random.Generator`` they draw the
same arrays bit for bit; ``glm_nuts`` builds its log-density from torch
tensors on the sampler's ``device``, and the evidence runs through this
package's ``MCEvidence`` on ``device`` (the card unless the caller asks
for the CPU).

Parity with the reference harness (examples.py:1-563) — the same two
likelihood surfaces with exactly known evidence and multiple samplers —
but with its latent bugs fixed (undefined ``reduce``/``det``/``harry``,
never-set ``ptheta``, inverted cache check; quirk Q11 in SURVEY.md) so every
example actually runs, and with asserting ``validate()`` helpers instead of
compare-by-eye.

* ``glm_eg``       — 3-param quadratic Gaussian linear model with closed-form
                     ln Z (reference examples.py:42-172) + Gibbs sampler.
* ``glm_nuts``     — the same GLM sampled with the native torch NUTS
                     (replaces the reference's PyStan harness,
                     examples.py:347-418).
* ``gaussian_eg``  — N-dim Gaussian with known truth (examples.py:267-342).
* ``gaussian_corr_eg`` — N-dim CORRELATED Gaussian (dense covariance;
                     whitening + Jacobian load-bearing; extension).
* ``banana_eg``    — 2-d curved non-Gaussian likelihood with
                     quadrature-exact evidence (extension; no linear map
                     makes it Gaussian).
* ``model_2d``     — 2-param straight-line likelihood for ensemble samplers
                     (examples.py:182-263).
* ``make_emcee_chain`` / ``gaussian_emcee`` — emcee integration, gated on
  emcee availability (examples.py:424-531).

Together with the iid Gaussian sampler this covers the reference's three
sampler families (Gibbs, NUTS, ensemble/iid) with asserting tests.

Run: ``python -m mcevidence_tpu_torch.examples
[gaussian_eg|gaussian_corr_eg|banana_eg|glm_eg|glm_nuts|gaussian_emcee|nested_eg]
[nsamples] [--device cuda|cuda:N|cpu]``.
"""

from __future__ import annotations

import math
import os
import sys
from functools import reduce
from typing import Optional

import logging

import numpy as np

logger = logging.getLogger(__name__)


class glm_eg:
    """Quadratic Gaussian linear model with analytic evidence.

    y = t0 + t1 x + t2 x^2 + noise; flat priors of width ``ptheta`` per
    parameter.  ``evidence()`` is the closed-form ln Z (reference
    examples.py:87-100); ``Sampler`` is a Gibbs sampler over the exact
    conditionals (examples.py:103-168).
    """

    def __init__(self, x=None, theta=None, rms=0.2, ptheta=None, verbose=1,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()
        if x is None:
            x = np.linspace(0.0, 4.0, 200)
        self.x = x
        self.ndata = len(x)
        if theta is None:
            theta = np.array([1.0, 4.0, -1.0])
        self.theta = theta
        self.ndim = len(theta)
        # flat prior widths (the reference never stored these — Q11)
        self.ptheta = np.repeat(10.0, self.ndim) if ptheta is None \
            else np.asarray(ptheta, float)

        self.y = self.quadratic(theta)
        self.noise_rms = np.full(self.ndata, rms)
        self.y_sample = self.y + self.rng.normal(0.0, self.noise_rms)

        self.D = np.zeros((self.ndata, self.ndim))
        self.D[:, 0] = 1.0 / self.noise_rms
        self.D[:, 1] = self.x / self.noise_rms
        self.D[:, 2] = self.x ** 2 / self.noise_rms
        self.b = self.y_sample / self.noise_rms
        # max-likelihood start point
        dtd_inv = np.linalg.inv(self.D.T @ self.D)
        self.theta_sample = reduce(np.dot, [dtd_inv, self.D.T, self.b])

    def quadratic(self, p):
        return p[0] + p[1] * self.x + p[2] * self.x ** 2

    def evidence(self) -> float:
        """Closed-form ln Z for the Gaussian linear model under flat priors.

        ln Z = 0.5 ln det(2 pi (D^T D)^-1)
               - 0.5 (b^T b - b^T D (D^T D)^-1 D^T b) - ln prod(ptheta).
        NOTE: the reference's version (examples.py:92) omits the 0.5 on the
        determinant term of the Gaussian integral — verified here against the
        kNN estimate itself (tests/test_examples.py).
        """
        b, D = self.b, self.D
        dtd_inv = np.linalg.inv(D.T @ D)
        num1 = 0.5 * np.log(np.linalg.det(2.0 * np.pi * dtd_inv))
        num2 = -0.5 * (b @ b - reduce(np.dot, [b.T, D, dtd_inv, D.T, b]))
        den1 = np.log(self.ptheta.prod())
        return num1 + num2 - den1

    def lnlike(self, params) -> float:
        r = self.b - self.D @ params
        return -0.5 * float(r @ r)

    def _gibbs_dist(self, params, i):
        """Sample parameter i from its exact conditional."""
        basis = [np.ones(self.ndata), self.x, self.x ** 2]
        v = basis[i] / self.noise_rms
        others = [j for j in range(3) if j != i]
        Do = np.stack([basis[j] / self.noise_rms for j in others], axis=1)
        theta_r = params[others]
        A = v @ v
        B = -2.0 * (self.b @ v - reduce(np.dot, [theta_r.T, Do.T, v]))
        mu = -B / (2.0 * A)
        sig = math.sqrt(1.0 / A)
        return self.rng.normal(mu, sig)

    def Sampler(self, nsamples=1000):
        n = int(nsamples)
        trace = np.zeros((n, 3))
        lnl = np.zeros(n)
        params = self.theta_sample.copy()
        for it in range(n):
            for i in range(3):
                params[i] = self._gibbs_dist(params, i)
            trace[it] = params
            lnl[it] = self.lnlike(params)
        self.theta_sample = params
        return trace, lnl

    def info(self):
        return (f"{self.ndim}-dimensional polynomial (Gaussian linear model) "
                "with closed-form evidence.")


class gaussian_eg:
    """N-dim Gaussian likelihood sampled exactly (reference examples.py:267-342).

    The sampler draws iid from the posterior, so with prior volume V the
    estimated ln Z converges to -ln V (the likelihood is normalized).
    """

    def __init__(self, ndim=10, ndata=10000, verbose=1,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()
        self.ndim = ndim
        self.ndata = ndata
        self.mean = np.arange(1.0, ndim + 1.0)
        self.d2d = self.rng.normal(self.mean, 1.0, size=(ndata, ndim))
        self.mean_sample = np.mean(self.d2d, axis=0)
        self.var_sample = np.var(self.d2d, axis=0)
        self.sigma_mean = np.std(self.d2d, axis=0) / math.sqrt(ndata)
        if verbose > 0:
            print("mean_sample=", self.mean_sample)
            print("std_sample=", np.sqrt(self.var_sample))

    def lnprob(self, theta):
        dm = (theta - self.mean_sample) / self.sigma_mean
        return (-0.5 * np.dot(dm, dm)
                - self.ndim * 0.5 * math.log(2.0 * math.pi)
                - np.sum(np.log(self.sigma_mean)))

    def Sampler(self, nsamples=1000):
        n = int(nsamples)
        theta = self.rng.normal(self.mean_sample, self.sigma_mean,
                                size=(n, self.ndim))
        dm = (theta - self.mean_sample) / self.sigma_mean
        f = (-0.5 * np.sum(dm * dm, axis=1)
             - self.ndim * 0.5 * math.log(2.0 * math.pi)
             - np.sum(np.log(self.sigma_mean)))
        return theta, f

    def pos(self, n):
        return self.rng.normal(self.mean_sample, 5 * self.sigma_mean,
                               size=(n, self.ndim))

    def info(self):
        return (f"{self.ndim}-dimensional multivariate Gaussian with "
                "normalized likelihood (lnZ -> -ln V_prior).")


class gaussian_corr_eg:
    """N-dim CORRELATED Gaussian likelihood sampled exactly.

    Extends the reference's diagonal ``gaussian_eg`` (examples.py:267-342)
    with a dense random covariance: the normalized likelihood
    N(theta; mu, Sigma) sampled iid via Cholesky, so ln Z -> -ln V_prior
    again — but now the estimator's whitening rotation and the
    sqrt(det Sigma) Jacobian (reference MCEvidence.py:865-877) are
    load-bearing: skipping either biases ln Z by O(ln det Sigma).
    """

    def __init__(self, ndim=6, corr_scale=0.7, verbose=1,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()
        self.ndim = ndim
        self.mean = np.arange(1.0, ndim + 1.0)
        # well-conditioned dense covariance: A A^T/ndim + diag jitter,
        # scaled to unit-ish variances with off-diagonal strength corr_scale
        a = self.rng.normal(size=(ndim, ndim))
        c = corr_scale * (a @ a.T) / ndim + np.diag(
            0.3 + self.rng.random(ndim))
        self.cov = c * 0.01             # compact posterior inside the prior
        self.chol = np.linalg.cholesky(self.cov)
        self.icov = np.linalg.inv(self.cov)
        sign, logdet = np.linalg.slogdet(self.cov)
        assert sign > 0
        self._lognorm = -0.5 * (ndim * math.log(2 * math.pi) + logdet)
        if verbose > 0:
            print("cov diag=", np.diag(self.cov), "logdet=", logdet)

    def lnprob(self, theta):
        dm = np.atleast_2d(theta) - self.mean
        q = np.einsum("ni,ij,nj->n", dm, self.icov, dm)
        out = -0.5 * q + self._lognorm
        return out[0] if np.ndim(theta) == 1 else out

    def Sampler(self, nsamples=1000):
        n = int(nsamples)
        z = self.rng.normal(size=(n, self.ndim))
        theta = self.mean + z @ self.chol.T
        # exact normalized log-density of the draws (q = |z|^2 by
        # construction: theta - mu = L z and q = z^T L^T Sigma^-1 L z)
        f = -0.5 * np.sum(z * z, axis=1) + self._lognorm
        return theta, f

    def pos(self, n):
        return self.mean + self.rng.normal(size=(n, self.ndim)) \
            @ (5 * self.chol.T)

    def info(self):
        return (f"{self.ndim}-dimensional correlated Gaussian "
                "(dense covariance; lnZ -> -ln V_prior; whitening + "
                "Jacobian load-bearing).")


class banana_eg:
    """2-d non-Gaussian "banana" likelihood with quadrature-exact evidence.

    L(t) = exp(-t1^2/(2 a^2) - (t2 - b t1^2)^2/(2 c^2)) over a uniform
    prior box: the posterior is curved in EVERY linear coordinate system,
    so the estimator's global whitening cannot straighten it — this is the
    first validation target that is not Gaussian after any linear map.
    The plane integral is exactly 2 pi a c (substitute u = t1,
    v = t2 - b t1^2, unit Jacobian); ``evidence()`` returns the
    box-truncated value by 2-d trapezoid quadrature so the truth is exact
    for the prior actually used.  ``Sampler`` draws iid exactly
    (t1 ~ N(0, a^2), t2|t1 ~ N(b t1^2, c^2)); ``pos`` supplies walker
    starts for the ensemble samplers.  Extends the reference's harness
    (reference examples.py:267-342 stops at Gaussians).
    """

    def __init__(self, a=1.0, b=1.0, c=0.5,
                 bounds=((-6.0, 6.0), (-3.0, 40.0)), verbose=1,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()
        self.ndim = 2
        self.a, self.b, self.c = float(a), float(b), float(c)
        self.bounds = bounds
        (l1, h1), (l2, h2) = bounds
        self.prior_volume = (h1 - l1) * (h2 - l2)
        self._lnz = None
        if verbose > 0:
            print(f"banana a={a} b={b} c={c} box={bounds} "
                  f"V={self.prior_volume:g}")

    def lnlike(self, theta):
        t = np.asarray(theta, np.float64)
        t1, t2 = t[..., 0], t[..., 1]
        return (-0.5 * (t1 / self.a) ** 2
                - 0.5 * ((t2 - self.b * t1 ** 2) / self.c) ** 2)

    lnprob = lnlike    # flat prior inside the box

    def evidence(self) -> float:
        """ln Z = ln( (1/V) * integral_box L ) by trapezoid quadrature
        (agrees with the exact plane integral 2 pi a c to ~1e-8 for the
        default box)."""
        if self._lnz is None:
            (l1, h1), (l2, h2) = self.bounds
            g1 = np.linspace(l1, h1, 4001)
            g2 = np.linspace(l2, h2, 4001)
            # broadcast the two coordinate axes directly: stacking a full
            # (4001, 4001, 2) meshgrid costs ~0.5 GB of transient float64
            # for what one (4001, 4001) grid expresses
            t1 = g1[:, None]
            ln = (-0.5 * (t1 / self.a) ** 2
                  - 0.5 * ((g2[None, :] - self.b * t1 ** 2) / self.c) ** 2)
            # np.trapezoid is NumPy >= 2.0; fall back to the 1.x name
            trap = getattr(np, "trapezoid", None) or np.trapz
            integral = trap(trap(np.exp(ln), g2, axis=1), g1)
            self._lnz = float(math.log(integral)
                              - math.log(self.prior_volume))
        return self._lnz

    def Sampler(self, nsamples=1000):
        n = int(nsamples)
        t1 = self.rng.normal(0.0, self.a, n)
        t2 = self.rng.normal(self.b * t1 ** 2, self.c)
        theta = np.stack([t1, t2], axis=1)
        return theta, self.lnlike(theta)

    def pos(self, n):
        return self.rng.normal([0.0, self.b * self.a ** 2], 0.5,
                               size=(n, self.ndim))

    def info(self):
        return ("2-d banana likelihood (curved, non-Gaussian in all linear "
                "coordinates) with quadrature-exact evidence.")


class glm_nuts:
    """NUTS chain for the GLM — the third sampler family of the reference's
    validation harness (its ``glm_stan`` ran PyStan NUTS,
    examples.py:347-418; here the native torch NUTS from
    ``mcevidence_tpu_torch.samplers`` replaces the external dependency).
    ``b`` and ``D`` are float64 tensors on ``device``, where the sampler
    evaluates the gradients; ``device="cuda"`` raises without a card.
    """

    def __init__(self, model: Optional[glm_eg] = None, seed: int = 0,
                 warmup: int = 400, verbose: int = 0, device="cuda"):
        import torch

        from .utils.device import resolve_device
        self.model = model if model is not None \
            else glm_eg(verbose=verbose, rng=np.random.default_rng(seed))
        self.seed = seed
        self.warmup = warmup
        self.ndim = self.model.ndim
        self.ptheta = self.model.ptheta
        self.device = resolve_device(device)
        b = torch.as_tensor(self.model.b, dtype=torch.float64,
                            device=self.device)
        D = torch.as_tensor(self.model.D, dtype=torch.float64,
                            device=self.device)

        def lnprob(x):
            r = b - D @ x
            return -0.5 * torch.dot(r, r)

        self.lnprob = lnprob

    def evidence(self) -> float:
        """Closed-form ln Z of the underlying GLM."""
        return self.model.evidence()

    def Sampler(self, nsamples=2000):
        from .samplers import nuts_sample
        return nuts_sample(self.lnprob, self.model.theta_sample,
                           int(nsamples), warmup=self.warmup,
                           seed=self.seed, device=self.device)

    def info(self):
        return ("NUTS (No-U-Turn, dual-averaging step size) chain for the "
                "Gaussian linear model with closed-form evidence.")


class model_2d:
    """2-param straight-line likelihood for ensemble samplers
    (reference examples.py:182-263)."""

    def __init__(self, p=(-0.9594, 4.294), pprior=None, N=50, x=None,
                 rng: Optional[np.random.Generator] = None, **kwargs):
        self.rng = rng or np.random.default_rng()
        p = np.asarray(p, float)
        if pprior is None:
            pprior = {f"p{i}": np.sort(np.array([t - 10 * abs(t),
                                                 t + 10 * abs(t)]))
                      for i, t in enumerate(p)}
        self.pprior = pprior
        self.label = list(self.pprior.keys())
        self.ndim = len(p)
        self.p = p
        if x is None:
            self.x = np.sort(10 * self.rng.random(N))
        else:
            self.x = np.asarray(x)
        self.N = len(self.x)
        self.y, self.yerr = self.data(**kwargs)

    def lnprior(self, theta):
        for i, t in enumerate(theta):
            lo, hi = self.pprior[self.label[i]]
            if not (lo < t < hi):
                return -np.inf
        return 0.0

    def lnlike(self, theta):
        m, b = theta
        model = m * self.x + b
        return -0.5 * np.sum(((self.y - model) / self.yerr) ** 2)

    def lnprob(self, theta):
        lp = self.lnprior(theta)
        if not np.isfinite(lp):
            return -np.inf
        return lp + self.lnlike(theta)

    def data(self, sigma=0.5, aerr=0.2):
        yerr = aerr + sigma * self.rng.random(self.N)
        y = self.p[0] * self.x + self.p[1]
        y = y + sigma * self.rng.standard_normal(self.N)
        return y, yerr

    def pos(self, nwalkers):
        r = self.rng.random((nwalkers, self.ndim))
        out = np.empty_like(r)
        for i, k in enumerate(self.label):
            lo, hi = self.pprior[k]
            out[:, i] = lo + (hi - lo) * r[:, i]
        return out

    def vis(self, samples, fname=None):
        """Corner plot of posterior samples with the truth marked
        (reference examples.py:247-263).  Uses the optional ``corner``
        package when installed, else a matplotlib pair-plot fallback;
        returns the figure (saved to ``fname`` when given)."""
        samples = np.asarray(samples)
        try:
            import corner
            fig = corner.corner(samples, labels=self.label,
                                truths=list(self.p))
        except ImportError:
            try:
                # no global backend switch: pyplot auto-selects Agg when
                # headless; only force it if the default backend fails
                try:
                    import matplotlib.pyplot as plt
                except Exception:
                    import matplotlib
                    matplotlib.use("Agg")
                    import matplotlib.pyplot as plt
            except ImportError:
                logger.warning("model_2d.vis: neither corner nor matplotlib "
                               "is installed; skipping plot")
                return None
            d = samples.shape[1]
            fig, axes = plt.subplots(d, d, figsize=(2.5 * d, 2.5 * d))
            axes = np.atleast_2d(axes)
            for i in range(d):
                for j in range(d):
                    ax = axes[i, j]
                    if j > i:
                        ax.axis("off")
                    elif i == j:
                        ax.hist(samples[:, i], bins=40, histtype="step")
                        ax.axvline(self.p[i], color="r")
                        ax.set_xlabel(self.label[i])
                    else:
                        ax.hist2d(samples[:, j], samples[:, i], bins=40)
                        ax.plot(self.p[j], self.p[i], "r+", markersize=10)
                        ax.set_xlabel(self.label[j])
                        ax.set_ylabel(self.label[i])
            fig.tight_layout()
        if fname:
            fig.savefig(fname)
        return fig


class make_emcee_chain:
    """Ensemble-sampler wrapper (reference examples.py:424-516): uses emcee
    when the optional package is installed, otherwise the native stretch-
    move sampler (``samplers.stretch_sample`` — the same Goodman & Weare
    algorithm), so the ensemble validation leg runs everywhere."""

    def __init__(self, model, nwalkers=500, nburn=300, arg=(), seed=0):
        self.model = model(*arg) if isinstance(model, type) else model
        self.ndim = self.model.ndim
        self.nwalkers = nwalkers
        self._seed = seed
        try:
            import emcee
        except ImportError:
            emcee = None
        if emcee is not None:
            self.emcee_sampler = emcee.EnsembleSampler(
                nwalkers, self.model.ndim, self.model.lnprob)
            state = self.emcee_sampler.run_mcmc(self.model.pos(nwalkers),
                                                nburn)
            self.state = state
            self.emcee_sampler.reset()
        else:
            from .samplers import stretch_sample
            self.emcee_sampler = None
            chain, _ = stretch_sample(self.model.lnprob,
                                      self.model.pos(nwalkers), nburn,
                                      seed=seed)
            self.state = chain[-1]

    def mcmc(self, nmcmc=2000, **kwargs):
        if self.emcee_sampler is not None:
            self.state = self.emcee_sampler.run_mcmc(self.state, nmcmc,
                                                     **kwargs)
            return (self.emcee_sampler.get_chain(flat=True),
                    self.emcee_sampler.get_log_prob(flat=True))
        from .samplers import stretch_sample
        # advance the seed per call so successive mcmc()/Sampler() segments
        # draw fresh stretch moves instead of replaying one RNG stream
        self._seed += 1
        chain, lnp = stretch_sample(self.model.lnprob, self.state, nmcmc,
                                    seed=self._seed)
        self.state = chain[-1]
        return (chain.reshape(-1, self.ndim), lnp.reshape(-1))

    def Sampler(self, nsamples=2000):
        nsteps = -(-int(nsamples) // self.nwalkers)
        samples, lnp = self.mcmc(nsteps)
        if self.emcee_sampler is not None:
            self.emcee_sampler.reset()
        return samples[:nsamples], lnp[:nsamples]


class nested_eg:
    """Toy nested-sampling run with analytic truth (no reference
    counterpart — the reference cannot read nested products at all).

    Likelihood: normalized N(0, sigma^2 I_d) inside the uniform prior box
    [-1, 1]^d, so ln Z_true = -ln V = -d ln 2 (likelihood mass outside the
    box < 1e-6 for sigma <= 0.2 at d = 2).  ``run()`` executes the REAL
    nested-sampling process — ``nlive`` live points, worst-point removal
    with deterministic shrinkage X_i = exp(-i/nlive), constrained-prior
    replacement (exact in-ball draws deep in the run, prior rejection
    early — see ``_constrained_draw``), prior-mass weights
    w_i = (X_{i-1} - X_i) L_i, and the standard final live-point
    correction — not a shortcut around it.  ``write_products()`` emits MultiNest-format files (weighted
    ``<root>.txt``, ``<root>post_equal_weights.dat``, ``<root>stats.dat``)
    so the ingestion path is validated end-to-end against the truth.
    """

    def __init__(self, ndim=2, sigma=0.2, nlive=300, verbose=1,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()
        self.ndim = int(ndim)
        self.sigma = float(sigma)
        self.nlive = int(nlive)
        self.verbose = verbose
        self.prior_volume = 2.0 ** self.ndim
        # lnL at the mode (run-constant, used by every constrained draw)
        self._lnl_peak = (-0.5 * self.ndim * math.log(2.0 * math.pi)
                          - self.ndim * math.log(self.sigma))
        self._run = None

    def lnlike(self, theta: np.ndarray) -> np.ndarray:
        theta = np.atleast_2d(theta)
        return (-0.5 * np.sum((theta / self.sigma) ** 2, axis=1)
                - 0.5 * self.ndim * math.log(2.0 * math.pi)
                - self.ndim * math.log(self.sigma))

    def evidence(self) -> float:
        """Analytic ln Z (the likelihood is normalized and fully inside
        the prior box): -ln V."""
        return -math.log(self.prior_volume)

    def _constrained_draw(self, lmin: float, x_frac: float) -> np.ndarray:
        """One prior draw with lnL > lmin.

        The constraint region {lnL > lmin} is the ball |theta| < r(lmin)
        (spherical Gaussian): once it lies fully inside the prior box the
        draw is made exactly — uniform direction x radius ~ u^(1/d) — which
        keeps deep-X iterations O(1) at any d (prior-rejection cost grows
        like 1/X and is hopeless by d ~ 8).  While the ball still pokes out
        of the box (early iterations, acceptance ~X ~ 1) batched rejection
        against the prior is used; both branches sample the SAME
        constrained-prior distribution, so this is the real NS process.
        """
        r2 = max(0.0, 2.0 * (self._lnl_peak - lmin)) * self.sigma ** 2
        r = math.sqrt(r2)
        if r < 1.0:
            direction = self.rng.normal(size=self.ndim)
            direction /= np.linalg.norm(direction)
            radius = r * self.rng.random() ** (1.0 / self.ndim)
            return radius * direction
        batch = int(min(2e5, max(64, 8.0 / max(x_frac, 1e-9))))
        while True:
            cand = self.rng.uniform(-1.0, 1.0, size=(batch, self.ndim))
            ok = np.nonzero(self.lnlike(cand) > lmin)[0]
            if ok.size:
                return cand[ok[0]]

    def run(self, frac_remaining: float = 1e-3):
        """Run NS to completion; returns (theta, lnl, weights) over dead +
        final live points, with weights the UNNORMALIZED posterior masses
        (sum = Z_NS estimate)."""
        if self._run is not None:
            return self._run
        nlive = self.nlive
        live = self.rng.uniform(-1.0, 1.0, size=(nlive, self.ndim))
        live_lnl = self.lnlike(live)
        shrink = math.exp(-1.0 / nlive)
        x_prev, z = 1.0, 0.0
        thetas, lnls, ws = [], [], []
        while True:
            # stop when even the best live point can add < frac_remaining;
            # checked BEFORE the kill so the final live set never contains
            # an already-recorded dead point (no double counting, no
            # duplicate rows in the posterior products)
            if z > 0.0 and (x_prev * math.exp(float(np.max(live_lnl)))
                            < frac_remaining * z):
                break
            i = int(np.argmin(live_lnl))
            lmin = float(live_lnl[i])
            x_new = x_prev * shrink
            thetas.append(live[i].copy())
            lnls.append(lmin)
            ws.append((x_prev - x_new) * math.exp(lmin))
            z += ws[-1]
            live[i] = self._constrained_draw(lmin, x_new)
            live_lnl[i] = self.lnlike(live[i][None, :])[0]
            x_prev = x_new
        for k in range(nlive):   # final live-point correction
            thetas.append(live[k])
            lnls.append(float(live_lnl[k]))
            ws.append(x_prev / nlive * math.exp(float(live_lnl[k])))
            z += ws[-1]
        theta = np.asarray(thetas)
        lnl = np.asarray(lnls)
        w = np.asarray(ws)
        if self.verbose > 0:
            print(f"nested run: {len(w) - nlive} iterations, "
                  f"lnZ_NS = {math.log(z):.4f} "
                  f"(analytic {self.evidence():.4f})")
        self._run = (theta, lnl, w)
        return self._run

    def ns_lnz(self):
        """The run's own (ln Z, err) — err via the classic sqrt(H/nlive)
        information estimate."""
        _, lnl, w = self.run()
        z = w.sum()
        p = w / z
        h = float(np.sum(p * (lnl - math.log(z))))
        return math.log(z), math.sqrt(max(h, 0.0) / self.nlive)

    def equal_weights(self):
        """MultiNest-style equal-weight posterior rows: accept row i with
        probability w_i / max(w) (each row at most once — duplicate-free
        input for the kNN estimator)."""
        theta, lnl, w = self.run()
        keep = self.rng.random(len(w)) < (w / w.max())
        return theta[keep], lnl[keep]

    def Sampler(self, nsamples=None):
        """Equal-weight posterior draws (``nsamples`` ignored: the run's
        effective sample size is what it is)."""
        return self.equal_weights()

    def write_products(self, outdir: str, root: str = "nested-",
                       style: str = "multinest") -> str:
        """Write nested-run products; returns the root path.

        ``style='multinest'``: ``<root>.txt`` + ``post_equal_weights.dat``
        + ``stats.dat``.  ``style='ultranest'``: a run directory with
        ``chains/weighted_post.txt`` / ``equal_weighted_post.txt``
        (header-named columns) + ``info/results.json``.
        """
        theta, lnl, w = self.run()
        p = w / w.sum()
        lnz, err = self.ns_lnz()
        eq_theta, eq_lnl = self.equal_weights()
        if style == "ultranest":
            rundir = os.path.join(outdir, root.rstrip("-"))
            os.makedirs(os.path.join(rundir, "chains"), exist_ok=True)
            os.makedirs(os.path.join(rundir, "info"), exist_ok=True)
            names = " ".join(f"p{j}" for j in range(self.ndim))
            np.savetxt(os.path.join(rundir, "chains", "weighted_post.txt"),
                       np.column_stack([p, lnl, theta]), fmt="%.16e",
                       header=f"weight logl {names}", comments="")
            np.savetxt(os.path.join(rundir, "chains",
                                    "equal_weighted_post.txt"),
                       np.column_stack([eq_lnl, eq_theta]), fmt="%.16e",
                       header=f"logl {names}", comments="")
            import json
            with open(os.path.join(rundir, "info", "results.json"), "w") as fp:
                json.dump({"logz": lnz, "logzerr": err}, fp)
            return rundir
        base = os.path.join(outdir, root)
        np.savetxt(base + ".txt",
                   np.column_stack([p, -2.0 * lnl, theta]), fmt="%.16e")
        np.savetxt(base + "post_equal_weights.dat",
                   np.column_stack([eq_theta, eq_lnl]), fmt="%.16e")
        with open(base + "stats.dat", "w") as fp:
            fp.write(" Nested Sampling Global Log-Evidence           :"
                     f"  {lnz:.15E} +/-  {err:.15E}\n")
        return base

    def info(self):
        return (f"{self.ndim}-d Gaussian likelihood under a true "
                f"nested-sampling run with {self.nlive} live points "
                f"(lnZ_true = {self.evidence():.4f}).")


def gaussian_emcee(nwalkers=300, nmcmc=50, kmax=3, device="cuda"):
    """End-to-end: N-dim Gaussian x emcee -> evidence (examples.py:518-531),
    the kNN selection on ``device``."""
    from .evidence import MCEvidence
    m = gaussian_eg(verbose=0)
    mec = make_emcee_chain(m, nwalkers=nwalkers)
    samples, lnp = mec.mcmc(nmcmc=nmcmc)
    chain = {"samples": samples, "loglikes": lnp}
    return MCEvidence(chain, verbose=1, ischain=True, kmax=kmax,
                      device=device).evidence()


METHODS = ("gaussian_eg", "gaussian_corr_eg", "glm_eg", "glm_nuts",
           "banana_eg", "gaussian_emcee", "nested_eg")


def build_parser():
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m mcevidence_tpu_torch.examples",
        description="Sample an analytic-truth example and estimate its ln Z.")
    p.add_argument("method", nargs="?", default="gaussian_eg",
                   choices=METHODS)
    p.add_argument("nsamples", nargs="?", default=10000, type=int)
    p.add_argument("--device", default="cuda",
                   help="where the kNN selection (and glm_nuts' gradients) "
                        "run: 'cuda' (default; fails without a GPU), "
                        "'cuda:N' or 'cpu'")
    return p


def main(argv=None) -> int:
    from .evidence import MCEvidence
    from .utils.device import resolve_device
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    method, nsamples = args.method, args.nsamples
    device = resolve_device(args.device)

    if method == "nested_eg":
        model = nested_eg(verbose=1)
        theta, lnl = model.Sampler()
        chain = {"samples": theta, "loglikes": lnl}
        mle = MCEvidence(chain, verbose=1, ischain=True,
                         priorvolume=model.prior_volume,
                         device=device).evidence()
        print("estimated ln Z (k=1..):", mle)
        lnz, err = model.ns_lnz()
        print(f"nested run's own ln Z: {lnz:.4f} +/- {err:.4f}")
        print("analytic ln Z:", model.evidence())
        return 0
    if method == "gaussian_emcee":
        print(gaussian_emcee(device=device))
        return 0
    if method == "glm_nuts":
        model = glm_nuts(verbose=1, device=device)
    else:
        model = globals()[method](verbose=1)
    print(f"Using example: {method}; sampling nsamples={nsamples}")
    samples, logl = model.Sampler(nsamples=nsamples)
    chain = {"samples": samples, "loglikes": logl}
    mle = MCEvidence(chain, thinlen=2, burnlen=0.1, verbose=1,
                     ischain=True,
                     priorvolume=getattr(model, "prior_volume", 1),
                     device=device).evidence()
    print("estimated ln Z (k=1..):", mle)
    if method.startswith("glm"):
        truth = model.evidence() + np.log(model.ptheta.prod())
        print("analytic ln Z (without prior volume):", truth)
    elif method == "banana_eg":
        print("quadrature ln Z:", model.evidence())
    else:
        print("analytic ln Z (unit prior volume): 0.0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
