"""The Heavens et al. (2017) kNN evidence of one chain, written plainly.

Whitening by the sample covariance (``np.cov``, rows as observations,
ddof=1) and its eigenbasis, an exhaustive float64 nearest-neighbour search
in blocks of query rows, and the estimator's sum as the method paper and
the original ``MCEvidence.py`` write it:

    vol_jk = pi^(d/2) D_jk^d / Gamma(1 + d/2)
    ln Z_k = ln( SumW * sum_j vol_jk / w_j * e^(lnL_j - lnL_max) / (S k + 1)
                 * sqrt(det C) ) + lnL_max - ln V_prior

for k = 1..kmax-1 in auto mode, the k-th neighbour other than the row
itself.  Independent of the program: it shares no code with it.
"""

import math

import numpy as np
import torch

BLOCK_BYTES = 1 << 30      # distance block of one query slab


def whiten(theta):
    """(whitened rows, ln sqrt(det C))."""
    theta = np.asarray(theta, np.float64)
    cov = np.atleast_2d(np.cov(theta.T))
    ev, vec = np.linalg.eigh(cov)
    if np.any(ev <= 0):
        raise ValueError("covariance not positive definite")
    white = (theta - theta.mean(0)) @ vec / np.sqrt(ev)
    return white, 0.5 * np.sum(np.log(ev))


def neighbour_distances(x, kmax, device):
    """(n, kmax) distances: column 0 the row itself (0), column k its k-th
    nearest other row, by an exhaustive float64 search.  Candidates are
    taken by the matrix identity with three spare, then measured again by
    differences and sorted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xs = torch.as_tensor(np.asarray(x, np.float64), device=device)
    n = xs.shape[0]
    keep = min(kmax - 1 + 3, n - 1)
    sq = (xs * xs).sum(1)
    block = max(1, min(n, BLOCK_BYTES // (8 * n)))
    out = np.zeros((n, kmax))
    for i0 in range(0, n, block):
        q = xs[i0:i0 + block]
        b = q.shape[0]
        d2 = sq[i0:i0 + b, None] + sq[None, :] - 2.0 * (q @ xs.T)
        rows = torch.arange(b, device=device)
        d2[rows, i0 + rows] = math.inf
        cand = torch.topk(d2, keep, dim=1, largest=False).indices
        del d2
        diff = q[:, None, :] - xs[cand]
        exact = torch.sort((diff * diff).sum(-1), dim=1).values
        out[i0:i0 + b, 1:] = torch.sqrt(exact[:, :kmax - 1]).cpu().numpy()
    return out


def log_evidence(theta, lnl, weights, kmax, device, sumw=None,
                 prior_volume=1.0):
    """ln Z for k = 1..kmax-1 of one chain in auto mode.  ``lnl`` is +lnL;
    ``sumw`` the sum of the adjusted weights (default: of ``weights``)."""
    theta = np.asarray(theta, np.float64)
    lnl = np.asarray(lnl, np.float64)
    w = np.asarray(weights, np.float64)
    n, d = theta.shape
    s, log_j = whiten(theta)
    dist = neighbour_distances(s, kmax, device)
    sumw = float(np.sum(w)) if sumw is None else float(sumw)
    lmax = float(np.max(lnl))
    fs = np.exp(lnl - lmax) / w
    unit_ball = math.pi ** (d / 2.0) / math.gamma(1.0 + d / 2.0)
    out = np.empty(kmax - 1)
    for k in range(1, kmax):
        vol = unit_ball * dist[:, k] ** d
        amax = float(np.dot(vol, fs)) / (n * k + 1.0)
        out[k - 1] = (math.log(sumw) + math.log(amax) + log_j + lmax
                      - math.log(prior_volume))
    return out
