"""Gradient-based MCMC: a self-contained No-U-Turn Sampler.

The counterpart of ``mcevidence_tpu.samplers``.  The reference validated
the evidence estimator on chains from three sampler families — Gibbs,
emcee, and PyStan NUTS (reference examples.py:347-418).  The NUTS leg is
provided natively: Hoffman & Gelman (2014) Algorithm 3 (efficient NUTS
with slice sampling and dynamic tree doubling) plus Algorithm 6's
dual-averaging step-size adaptation, with gradients from
``torch.autograd`` so any torch-differentiable log-density works out of
the box.

The tree recursion runs on the host in numpy, as in the JAX package, so
that for the same (value, gradient) function and seed both packages make
the same draws bit for bit; only the (value, gradient) evaluation runs on
``device``.  The targets are a handful of dimensions, so on the card every
evaluation is a few launches and a synchronisation (the scalar and the
gradient come back to the host for the recursion).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .utils.device import resolve_device

logger = logging.getLogger(__name__)

_DELTA_MAX = 1000.0      # divergence threshold (Hoffman & Gelman eq. after Alg. 3)


def _make_vgrad(lnprob: Callable, device):
    """``f(x: np.ndarray) -> (float, np.float64 gradient)`` of
    ``sum(lnprob(x))``, with ``x`` handed to ``lnprob`` as a float64 tensor
    on ``device`` that requires grad.  Tensors that ``lnprob`` closes over
    must live on the same device: torch raises on a mix, where a quiet copy
    would cost a transfer every leapfrog step."""
    dev = resolve_device(device)

    def _eval(x):
        t = torch.tensor(x, dtype=torch.float64, device=dev,
                         requires_grad=True)
        v = torch.sum(lnprob(t))
        (g,) = torch.autograd.grad(v, t)
        return v.detach(), g

    warned = [False]

    def f(x: np.ndarray) -> Tuple[float, np.ndarray]:
        v, g = _eval(x)
        # both fetches wait for the device: honest timing
        out = float(v), g.cpu().numpy().astype(np.float64)
        if not warned[0]:
            warned[0] = True
            # a warm evaluation of a few-dimensional target is tens of us on
            # the host and a few launches and one synchronisation on the
            # card; a persistent multi-ms scale means every leapfrog step
            # pays for it — sample a SECOND eval to skip first-call set-up
            # before warning
            t1 = time.perf_counter()
            v2, g2 = _eval(x)
            float(v2), g2.cpu()
            if time.perf_counter() - t1 > 0.05:
                logger.warning(
                    "NUTS gradient evaluations look slow (warm eval %.3fs on "
                    "%s).  Each leapfrog step evaluates lnprob once, so this "
                    "cost dominates the sampling wall-clock; a few-parameter "
                    "target is usually fastest with device='cpu'.",
                    time.perf_counter() - t1, dev)
        return out

    return f


def _leapfrog(f, x, p, grad, eps, inv_mass):
    """One leapfrog step under a diagonal metric: momenta p ~ N(0, M),
    kinetic = p^T M^-1 p / 2, position update uses M^-1 p."""
    p1 = p + 0.5 * eps * grad
    x1 = x + eps * inv_mass * p1
    lp1, grad1 = f(x1)
    p1 = p1 + 0.5 * eps * grad1
    return x1, p1, lp1, grad1


def _kinetic(p, inv_mass):
    return 0.5 * float(p @ (inv_mass * p))


def _find_reasonable_epsilon(f, x, rng, inv_mass) -> float:
    """Heuristic initial step size (Hoffman & Gelman, Algorithm 4)."""
    eps = 1.0
    p = rng.standard_normal(x.shape) / np.sqrt(inv_mass)
    lp, grad = f(x)
    x1, p1, lp1, _ = _leapfrog(f, x, p, grad, eps, inv_mass)
    joint0 = lp - _kinetic(p, inv_mass)
    joint1 = lp1 - _kinetic(p1, inv_mass)
    if not np.isfinite(joint1):
        joint1 = -np.inf
    a = 1.0 if joint1 - joint0 > math.log(0.5) else -1.0
    while a * (joint1 - joint0) > -a * math.log(2.0):
        eps = eps * (2.0 ** a)
        if eps > 1e7 or eps < 1e-7:
            break
        x1, p1, lp1, _ = _leapfrog(f, x, p, grad, eps, inv_mass)
        joint1 = lp1 - _kinetic(p1, inv_mass)
        if not np.isfinite(joint1):
            joint1 = -np.inf
    return eps


def _build_tree(f, x, p, grad, logu, v, j, eps, joint0, rng, inv_mass):
    """One NUTS subtree (Hoffman & Gelman, Algorithm 3 / 6)."""
    if j == 0:
        x1, p1, lp1, grad1 = _leapfrog(f, x, p, grad, v * eps, inv_mass)
        joint = lp1 - _kinetic(p1, inv_mass)
        if not np.isfinite(joint):
            joint = -np.inf
        n1 = int(logu <= joint)
        s1 = int(logu < joint + _DELTA_MAX)
        alpha = min(1.0, math.exp(min(0.0, joint - joint0)))
        return (x1, p1, grad1, x1, p1, grad1, x1, lp1, grad1,
                n1, s1, alpha, 1)
    (xm, pm, gm, xp, pp, gp, x1, lp1, g1,
     n1, s1, alpha, nalpha) = _build_tree(f, x, p, grad, logu, v, j - 1,
                                          eps, joint0, rng, inv_mass)
    if s1 == 1:
        if v == -1:
            (xm, pm, gm, _, _, _, x2, lp2, g2,
             n2, s2, a2, na2) = _build_tree(f, xm, pm, gm, logu, v, j - 1,
                                            eps, joint0, rng, inv_mass)
        else:
            (_, _, _, xp, pp, gp, x2, lp2, g2,
             n2, s2, a2, na2) = _build_tree(f, xp, pp, gp, logu, v, j - 1,
                                            eps, joint0, rng, inv_mass)
        if n1 + n2 > 0 and rng.random() < n2 / (n1 + n2):
            x1, lp1, g1 = x2, lp2, g2
        alpha += a2
        nalpha += na2
        # U-turn criterion under the metric: velocities are M^-1 p
        dx = xp - xm
        s1 = s2 * int(dx @ (inv_mass * pm) >= 0) \
            * int(dx @ (inv_mass * pp) >= 0)
        n1 += n2
    return xm, pm, gm, xp, pp, gp, x1, lp1, g1, n1, s1, alpha, nalpha


def nuts_sample(lnprob: Callable, x0: np.ndarray, nsamples: int, *,
                warmup: int = 500, seed: Optional[int] = None,
                target_accept: float = 0.8, max_depth: int = 10,
                adapt_mass: bool = True, device="cuda"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Draw ``nsamples`` post-warmup NUTS samples from ``lnprob``.

    Args:
      lnprob: torch-differentiable log density f(x: (d,) float64 tensor on
        ``device``) -> scalar tensor.
      x0: (d,) start point.
      warmup: adaptation steps (discarded).  The first 60% run with a unit
        metric and dual-averaged step size; a diagonal mass matrix is then
        estimated from those draws (Stan-style windowed adaptation,
        simplified to one window) and the step size re-adapted under it.
      target_accept: dual-averaging target acceptance statistic.
      adapt_mass: disable to keep the unit metric throughout.
      device: where the gradient evaluations run, ``"cuda"`` (default;
        raises without a card) or ``"cpu"``.

    Returns (samples (nsamples, d) float64, lnp (nsamples,) float64).
    """
    rng = np.random.default_rng(seed)
    f = _make_vgrad(lnprob, device)
    x = np.asarray(x0, np.float64)
    lp, grad = f(x)
    d = x.shape[0]
    inv_mass = np.ones(d)           # M^-1; momenta ~ N(0, M)

    switch = int(0.6 * warmup) if adapt_mass and warmup >= 100 else warmup
    warm_draws = np.zeros((switch, d))

    def fresh_dual_averaging():
        e = _find_reasonable_epsilon(f, x, rng, inv_mass)
        return e, math.log(10.0 * e), 0.0, 0.0, 0
    eps, mu, log_eps_bar, h_bar, m_adapt = fresh_dual_averaging()
    gamma, t0, kappa = 0.05, 10.0, 0.75

    total = warmup + nsamples
    samples = np.zeros((nsamples, d))
    lnps = np.zeros(nsamples)
    for m in range(1, total + 1):
        p0 = rng.standard_normal(d) / np.sqrt(inv_mass)
        joint0 = lp - _kinetic(p0, inv_mass)
        logu = joint0 + math.log(rng.random())
        xm = xp = x
        pm = pp = p0
        gm = gp = grad
        x_new, lp_new, g_new = x, lp, grad
        j, n, s = 0, 1, 1
        alpha, nalpha = 0.0, 1
        while s == 1 and j < max_depth:
            v = 1 if rng.random() < 0.5 else -1
            if v == -1:
                (xm, pm, gm, _, _, _, x1, lp1, g1,
                 n1, s1, alpha, nalpha) = _build_tree(
                    f, xm, pm, gm, logu, v, j, eps, joint0, rng, inv_mass)
            else:
                (_, _, _, xp, pp, gp, x1, lp1, g1,
                 n1, s1, alpha, nalpha) = _build_tree(
                    f, xp, pp, gp, logu, v, j, eps, joint0, rng, inv_mass)
            if s1 == 1 and rng.random() < min(1.0, n1 / n):
                x_new, lp_new, g_new = x1, lp1, g1
            n += n1
            dx = xp - xm
            s = s1 * int(dx @ (inv_mass * pm) >= 0) \
                * int(dx @ (inv_mass * pp) >= 0)
            j += 1
        x, lp, grad = x_new, lp_new, g_new

        if m <= warmup:     # dual averaging (Algorithm 6)
            m_adapt += 1
            frac = 1.0 / (m_adapt + t0)
            h_bar = (1.0 - frac) * h_bar + frac * (
                target_accept - alpha / max(nalpha, 1))
            log_eps = mu - math.sqrt(m_adapt) / gamma * h_bar
            w = m_adapt ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            eps = math.exp(log_eps)
            if m <= switch:
                warm_draws[m - 1] = x
            if m == switch and switch < warmup:
                # estimate the diagonal metric from the later warm draws
                # (regularized toward unit, Stan-style), then re-adapt eps
                tail = warm_draws[switch // 2:]
                var = np.var(tail, axis=0, ddof=1)
                nw = len(tail)
                inv_mass = (nw / (nw + 5.0)) * var \
                    + (5.0 / (nw + 5.0)) * 1e-3
                inv_mass = np.maximum(inv_mass, 1e-10)
                eps, mu, log_eps_bar, h_bar, m_adapt = \
                    fresh_dual_averaging()
            if m == warmup:
                eps = math.exp(log_eps_bar)
        else:
            samples[m - warmup - 1] = x
            lnps[m - warmup - 1] = lp
    return samples, lnps


def stretch_sample(lnprob: Callable, p0: np.ndarray, nsteps: int, *,
                   a: float = 2.0,
                   seed: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Affine-invariant ensemble sampler: the Goodman & Weare (2010)
    stretch move — the algorithm behind emcee, which the reference used for
    its ensemble validation leg (reference examples.py:424-516).  Provided
    natively so that leg runs without the optional emcee dependency.  It
    evaluates a numpy ``lnprob`` walker by walker on the host: it has no
    device.

    ``lnprob(theta) -> float`` evaluates one walker; ``p0`` is the
    (nwalkers, ndim) initial ensemble (nwalkers >= 2*ndim recommended, and
    at least 4).  Returns ``(chain, lnp)`` with shapes
    (nsteps, nwalkers, ndim) and (nsteps, nwalkers).

    Standard parallel-update scheme: the ensemble is split in two halves
    and each half stretches against partners drawn from the other, with
    acceptance ln r = (d-1) ln z + lnp' - lnp.
    """
    rng = np.random.default_rng(seed)
    x = np.array(p0, np.float64)
    nw, nd = x.shape
    if nw < 4:
        raise ValueError("stretch_sample needs at least 4 walkers")
    lp = np.array([lnprob(t) for t in x], np.float64)
    chain = np.empty((nsteps, nw, nd))
    lps = np.empty((nsteps, nw))
    half = nw // 2
    first, second = np.arange(half), np.arange(half, nw)
    for s in range(nsteps):
        for active, other in ((first, second), (second, first)):
            z = ((a - 1.0) * rng.random(len(active)) + 1.0) ** 2 / a
            partners = other[rng.integers(0, len(other), len(active))]
            prop = x[partners] + z[:, None] * (x[active] - x[partners])
            lp_prop = np.array([lnprob(t) for t in prop], np.float64)
            with np.errstate(invalid="ignore"):
                lnr = (nd - 1) * np.log(z) + lp_prop - lp[active]
            acc = np.log(rng.random(len(active))) < lnr
            x[active[acc]] = prop[acc]
            lp[active[acc]] = lp_prop[acc]
        chain[s] = x
        lps[s] = lp
    return chain, lps
