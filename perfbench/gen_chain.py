"""Chains drawn exactly from their own normalised Gaussian likelihood.

The generator of ``mcevidence_tpu_torch/bench.py:synthetic_chain``, frozen
here and widened as the chain configurations state: a covariance drawn from
the seed (a random correlation and per-parameter scales), and integer
multiplicity weights as CosmoMC writes them.

Every seed does the same work.  The standard-normal points of each chain
come from the configuration's fixed ``structure_seed``; the seed draws
everything else (the covariance and mean that map them to parameters, the
weights, the order of the rows and of the pool).  Whitening takes any such
map back to the same point configuration (Mahalanobis distances under the
sample covariance are affine-invariant), so every seed has the same
neighbours and the same near-ties, and the program's guard reselects for
the same chains, while the numbers the program reads are new.
"""

import numpy as np


def rng_for(seed, *stream):
    """A numpy generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2 ** 64, *stream]))


def correlated_gaussian(rng, d, scales):
    """(mean, Cholesky factor) of a Gaussian with a random correlation and
    the given per-parameter scales."""
    a = rng.normal(size=(d, d))
    c = a @ a.T + d * np.eye(d)
    s = np.sqrt(np.diag(c))
    corr = c / np.outer(s, s)
    cov = corr * np.outer(scales, scales)
    return np.linalg.cholesky(cov)


def gaussian_chain(points, rng, n, d, wmin=1, wmax=4):
    """One chain as ``MCEvidence`` takes arrays: ``samples`` (n, d),
    ``loglikes`` (+lnL, normalised, so ln Z = 0 before any prior volume)
    and integer ``weights`` in [wmin, wmax].  ``points`` draws the
    standard-normal points, ``rng`` the rest."""
    z = points.standard_normal((n, d))[rng.permutation(n)]
    scales = 10.0 ** rng.uniform(-3.0, 0.0, d)
    mean = rng.normal(size=d)
    chol = correlated_gaussian(rng, d, scales)
    theta = mean + z @ chol.T
    lnl = (-0.5 * np.sum(z * z, axis=1) - 0.5 * d * np.log(2 * np.pi)
           - np.sum(np.log(np.diag(chol))))
    w = rng.integers(wmin, wmax + 1, size=n).astype(np.float64)
    return {"samples": theta, "loglikes": lnl, "weights": w}


def chain_pool(seed, cfg):
    """``cfg["pool"]`` distinct chains of ``cfg["rows"]`` x ``cfg["ndim"]``
    from ``seed``, in an order drawn from it."""
    wmin, wmax = cfg["weights"]
    pool = [gaussian_chain(rng_for(cfg["structure_seed"], i),
                           rng_for(seed, i), cfg["rows"], cfg["ndim"],
                           wmin, wmax) for i in range(cfg["pool"])]
    order = rng_for(seed, cfg["pool"]).permutation(cfg["pool"])
    return [pool[i] for i in order]
