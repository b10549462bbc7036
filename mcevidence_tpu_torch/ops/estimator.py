"""The Heavens et al. (2017) kNN evidence estimator as a fused reduction.

Reference inner loop (MCEvidence.py:1107-1131): for each k,
    volume[j,k] = pi^(d/2) * D_jk^d / Gamma(1 + d/2)
    dotp        = sum_j volume[j,k] / w_j * exp(lnL_j - lnL_max)
    amax        = dotp / (S * k_nn + 1)
    MLE[k]      = ln(SumW * amax * J) + lnL_max - ln V_prior

computed there with a Python double loop over (j, k).  Here the whole thing
is one log-space reduction:

    ln dotp_k = logsumexp_j [ (d/2) ln pi + d ln D_jk - ln Gamma(1 + d/2)
                              - ln w_j + (lnL_j - lnL_max) ]
    MLE_k     = ln SumW + ln dotp_k - ln(S k_nn + 1) + ln J
                + lnL_max - ln V_prior

which is algebraically identical, numerically stabler (D^d never leaves log
space), and vectorizes over (j, k).  This is the float64 numpy twin the
refine path runs on the host (``mcevidence_tpu/ops/estimator.py:112``).

Conventions preserved from the reference:
* auto mode:  distance columns include the self match at k=0; columns
  k = 1..kmax-1 are used with k_nn = k (MCEvidence.py:1097-1101,1120-1123).
* cross mode: columns are genuine NNs starting at k=0 with k_nn = k+1
  (MCEvidence.py:1093-1096,1120-1123).
* SumW is the sum of the *adjusted* weights of the whole s1 partition (not
  the batch) — MCEvidence.py:1126; importance reweighting enters only here
  (quirk Q7).
* The row for k=0 in auto mode is left at 0 (self distance), and callers
  slice off column 0 (quirk Q2).
"""

from __future__ import annotations

import math

import numpy as np


def log_ball_volume_const(ndim) -> float:
    """ln of the unit-ndim-ball volume prefactor: (d/2) ln pi - ln Gamma(1+d/2)."""
    return 0.5 * ndim * math.log(math.pi) - math.lgamma(1.0 + 0.5 * ndim)


def log_evidence_from_knn_np(dknn, lnlike, weights, sum_adjusted_weights,
                             ndim, log_jacobian, log_prior_volume,
                             k_start, nsamples=None) -> np.ndarray:
    """The estimator in float64 numpy (host parity path).

    ``dknn`` (S, K) sorted kNN distances; ``lnlike`` +lnL; ``weights`` the
    unadjusted MCMC weights; ``k_start`` 1 in auto mode (column 0 is the
    self match), 0 in cross mode.  Returns MLE_k per column, with columns
    below ``k_start`` left at 0."""
    dknn = np.asarray(dknn, np.float64)
    lnlike = np.asarray(lnlike, np.float64)
    weights = np.asarray(weights, np.float64)
    S = dknn.shape[0] if nsamples is None else nsamples
    K = dknn.shape[1]
    lnl_max = np.max(lnlike)
    fs = lnlike - lnl_max
    log_c = log_ball_volume_const(ndim)
    with np.errstate(divide="ignore"):
        log_d = np.where(dknn > 0, np.log(np.where(dknn > 0, dknn, 1.0)), -np.inf)
    log_terms = (log_c + ndim * log_d) + (fs - np.log(weights))[:, None]
    m = np.max(log_terms, axis=0)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        log_dotp = m_safe + np.log(np.sum(np.exp(log_terms - m_safe), axis=0))
    k_idx = np.arange(K)
    k_nn = k_idx if k_start == 1 else k_idx + 1
    log_amax = log_dotp - np.log(S * k_nn + 1.0)
    mle = (np.log(sum_adjusted_weights) + log_amax + log_jacobian
           + lnl_max - log_prior_volume)
    mle[k_idx < k_start] = 0.0
    return mle
