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
space), and vectorizes over (j, k).  ``log_evidence_from_knn_np`` is the
float64 numpy twin the refine path runs on the host
(``mcevidence_tpu/ops/estimator.py:112``); ``log_evidence_from_knn`` is the
torch reduction the ``fast`` precision runs on the card in f32
(``mcevidence_tpu/ops/estimator.py:50``, batched like
``mcevidence_tpu/parallel/ring.py:_reduce_mle``).

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
from typing import Optional

import numpy as np
import torch


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


def _as_batch(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-member value as a tensor on ``like``'s device and
    dtype, with a trailing axis to broadcast against the k columns."""
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device)[..., None]


def log_evidence_from_knn(dknn: torch.Tensor, lnlike: torch.Tensor,
                          weights: torch.Tensor, sum_adjusted_weights,
                          ndim: int, log_jacobian, log_prior_volume,
                          k_start: int, nsamples=None,
                          valid: Optional[torch.Tensor] = None,
                          squared: bool = False) -> torch.Tensor:
    """The fused estimator on the tensors' device and dtype.

    ``dknn`` (..., S, K) sorted kNN distances (squared when ``squared``),
    ``lnlike``/``weights``/``valid`` (..., S) over the same leading batch
    axes; ``sum_adjusted_weights``, ``log_jacobian``, ``log_prior_volume``
    and ``nsamples`` (S of the amax denominator, default the rows of
    ``dknn``) are scalars or (...,) per member.  Rows with ``valid == 0``
    contribute nothing.  Zero distances give -inf terms (volume 0, as in
    the reference).  Returns (..., K) MLE_k with the columns below
    ``k_start`` set to 0."""
    k = dknn.shape[-1]
    if nsamples is None:
        nsamples = dknn.shape[-2]
    if valid is None:
        lnl_max = lnlike.amax(dim=-1)
    else:
        lnl_max = torch.where(valid > 0, lnlike, -math.inf).amax(dim=-1)
    fs = lnlike - lnl_max[..., None]
    pos = dknn > 0
    log_d = torch.where(pos, torch.log(torch.where(pos, dknn, 1.0)),
                        -math.inf)
    d_pow = 0.5 * ndim if squared else ndim
    log_terms = (log_ball_volume_const(ndim) + d_pow * log_d
                 + (fs - torch.log(weights))[..., None])
    if valid is not None:
        log_terms = torch.where(valid[..., None] > 0, log_terms, -math.inf)
    log_dotp = torch.logsumexp(log_terms, dim=-2)             # (..., K)
    k_idx = torch.arange(k, device=dknn.device)
    k_nn = (k_idx if k_start == 1 else k_idx + 1).to(log_dotp.dtype)
    # S*k+1 in floating point, as ring.py:_reduce_mle takes it
    log_amax = log_dotp - torch.log(_as_batch(nsamples, log_dotp) * k_nn
                                    + 1.0)
    mle = (torch.log(_as_batch(sum_adjusted_weights, log_dotp)) + log_amax
           + _as_batch(log_jacobian, log_dotp) + lnl_max[..., None]
           - _as_batch(log_prior_volume, log_dotp))
    return torch.where(k_idx < k_start, torch.zeros_like(mle), mle)
