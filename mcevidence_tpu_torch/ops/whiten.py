"""Whitening (pre-whitening) of posterior samples.

The reference whitens by rotating samples into the covariance eigenbasis and
rescaling each axis to unit variance, with Jacobian = sqrt(det(C)); if any
eigenvalue is negative it warns and skips whitening with Jacobian = 1
(reference MCEvidence.py:842-947).

kNN *distances* are invariant to which unit-covariance whitener is used (any
two differ by an orthogonal map), so we use the symmetric ``eigh`` instead of
the reference's general ``eig`` — better conditioned, never complex, same
distances and same Jacobian (SURVEY.md §2.4).

``whiten_stats``/``apply_whiten`` are the numpy float64 (host) half of
``mcevidence_tpu/ops/whiten.py``: the refine and device paths whiten on the
host, where the O(N d^2) work is not worth a device round-trip on its own.
``whiten_masked`` is the torch counterpart of ``whiten_masked_jnp``, which
the ``fast`` precision runs on the card in f32.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

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


def _whiten_from_cov(samples: torch.Tensor, cov: torch.Tensor):
    """eigh + posdef select + rotate/rescale (``_whiten_from_cov_jnp``):
    a covariance that is not positive definite, or not finite, falls back to
    the identity transform with log_jacobian = 0.  Batched over leading
    dimensions.  The rotation runs in f64 and is cast back, so no TF32
    switch can round it."""
    d = cov.shape[-1]
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    eigvals, eigvecs = torch.linalg.eigh(
        torch.where(finite[..., None, None], cov, eye))
    posdef = (eigvals > 0).all(dim=-1) & finite
    safe = torch.where(eigvals > 0, eigvals, torch.ones_like(eigvals))
    log_j = torch.where(posdef, 0.5 * torch.log(safe).sum(dim=-1),
                        torch.zeros_like(safe[..., 0]))
    rot = (samples.double() @ eigvecs.double()).to(samples.dtype)
    white = torch.where(posdef[..., None, None],
                        rot / torch.sqrt(safe)[..., None, :], samples)
    return white, log_j, posdef


def whiten_masked(samples: torch.Tensor, valid: torch.Tensor):
    """Whitening from masked moments on the samples' device: rows with
    ``valid == 0`` (padding) stay out of the covariance; the rotation is
    applied to every row.  ``samples`` (..., N, d) f32, ``valid`` (..., N);
    returns (whitened, log_jacobian (...,), posdef (...,)).

    The uncentred-moment form ``sxx - n mu mu^T`` cancels at large
    |mean|/std, so callers centre the true rows first (in f64 on the host).
    The d x d moments are summed in f64 and cast to the samples' dtype: the
    JAX package takes them at ``Precision.HIGHEST``, and a matrix product
    in f64 is one that ``torch.backends.cuda.matmul.allow_tf32`` cannot
    round.  ``torch.linalg.eigh`` then runs in the samples' dtype, as
    ``jnp.linalg.eigh`` does."""
    x = samples.double()
    w = valid.double()[..., None]
    n = w.sum(dim=-2)                                      # (..., 1)
    sw = x * w
    mean = sw.sum(dim=-2) / n                              # (..., d)
    sxx = sw.transpose(-1, -2) @ x                         # (..., d, d)
    cov = ((sxx - n[..., None] * mean[..., :, None] * mean[..., None, :])
           / (n[..., None] - 1.0))
    return _whiten_from_cov(samples, cov.to(samples.dtype))
