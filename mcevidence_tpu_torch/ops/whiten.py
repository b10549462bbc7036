"""Whitening (pre-whitening) of posterior samples.

The reference whitens by rotating samples into the covariance eigenbasis and
rescaling each axis to unit variance, with Jacobian = sqrt(det(C)); if any
eigenvalue is negative it warns and skips whitening with Jacobian = 1
(reference MCEvidence.py:842-947).

kNN *distances* are invariant to which unit-covariance whitener is used (any
two differ by an orthogonal map), so we use the symmetric ``eigh`` instead of
the reference's general ``eig`` — better conditioned, never complex, same
distances and same Jacobian (SURVEY.md §2.4).

This is the numpy float64 (host) half of ``mcevidence_tpu/ops/whiten.py``:
the refine path whitens on the host, where the O(N d^2) work is not worth a
device round-trip on its own.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WhitenStats:
    """Covariance eigen-decomposition + Jacobian for a sample set."""

    cov: np.ndarray          # (d, d)
    eigvals: np.ndarray      # (d,)
    eigvecs: np.ndarray      # (d, d) columns
    log_jacobian: float      # ln sqrt(det C); 0.0 when not positive definite
    posdef: bool             # False => whitening skipped (reference fallback)

    @property
    def jacobian(self) -> float:
        return float(np.exp(self.log_jacobian))


def covariance(samples: np.ndarray) -> np.ndarray:
    """Sample covariance with the reference's normalization (np.cov: rows are
    variables, ddof=1; reference MCEvidence.py:865,916).

    np.cov's 0/0 RuntimeWarnings for n < 2 are suppressed — the resulting
    non-finite covariance is handled deliberately by ``whiten_stats``
    (warn-and-skip), which emits the intended signal."""
    import warnings
    with np.errstate(divide="ignore", invalid="ignore"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.cov(np.asarray(samples, dtype=np.float64).T)


def whiten_stats(samples: np.ndarray,
                 cov: Optional[np.ndarray] = None) -> WhitenStats:
    """Eigen-decompose the sample covariance; detect the degenerate case.

    Negative eigenvalue => warn and mark non-posdef: callers then skip the
    rotation and use Jacobian=1 (reference MCEvidence.py:867-878,920-931).

    ``cov``: precomputed covariance — callers that already hold centred
    samples pass their own GEMM result and skip np.cov's internal copies
    (the device-refine host prep).
    """
    c = covariance(samples) if cov is None else np.asarray(cov, np.float64)
    c = np.atleast_2d(c)
    if not np.all(np.isfinite(c)):
        # < 2 rows (np.cov divides by n-1 = 0) or NaN samples: eigh would
        # raise LinAlgError; treat as degenerate like the singular case
        logger.warning(
            "covariance is not finite (fewer than 2 samples, or NaN/inf "
            "coordinates): chain not whitened")
        d = c.shape[0]
        return WhitenStats(cov=c, eigvals=np.zeros(d), eigvecs=np.eye(d),
                           log_jacobian=0.0, posdef=False)
    try:
        eigvals, eigvecs = np.linalg.eigh(c)
    except np.linalg.LinAlgError as e:     # belt-and-braces: finite input
        logger.warning("covariance eigh failed (%s): chain not whitened", e)
        d = c.shape[0]
        return WhitenStats(cov=c, eigvals=np.zeros(d), eigvecs=np.eye(d),
                           log_jacobian=0.0, posdef=False)
    # <= 0: the reference only tests < 0 and then crashes on math.log(0) for
    # an exactly-singular covariance (a constant parameter column); treating
    # zero as degenerate matches the device paths and keeps the run alive.
    if np.any(eigvals <= 0):
        logger.warning(
            "covariance has non-positive eigenvalues %s: chain not whitened, "
            "estimated evidence may be inaccurate (consider fewer params "
            "via ndim)", eigvals)
        return WhitenStats(cov=c, eigvals=eigvals, eigvecs=eigvecs,
                           log_jacobian=0.0, posdef=False)
    # ln J = 0.5 ln det C = 0.5 sum ln eigvals
    log_j = 0.5 * float(np.sum(np.log(eigvals)))
    return WhitenStats(cov=c, eigvals=eigvals, eigvecs=eigvecs,
                       log_jacobian=log_j, posdef=True)


def apply_whiten(samples: np.ndarray, stats: WhitenStats) -> np.ndarray:
    """Rotate + rescale samples to unit covariance (reference
    ``diagonalise_chain``, MCEvidence.py:842-849).  No-op when not posdef."""
    if not stats.posdef:
        return np.asarray(samples, dtype=np.float64)
    s = np.asarray(samples, dtype=np.float64)
    return (s @ stats.eigvecs) / np.sqrt(stats.eigvals)
