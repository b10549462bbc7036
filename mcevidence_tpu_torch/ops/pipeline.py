"""Device-resident evidence: the ``device`` and ``fast`` precisions.

The counterpart of ``mcevidence_tpu/ops/pipeline.py``.  One ``device``
estimate runs:

  host f64 whitening -> upload of the f64 whitened coordinates (an f32 copy
  is cast on the card for the selection) and of scal = exp(lnL - lnL_max)/w
  -> f32 kNN candidate selection on the card (the indices never leave it)
  -> f64 refinement of the candidates' d2, the thin-margin statistic,
  (d2 * inv_s2)^(ndim/2) * scal and its sum over rows, all on the card
  -> kmax+1 scalars back -> f64 host bookkeeping.

The card computes in native float64, so the JAX package's double-float
pairs (``ops/dfloat.py``), its XLA:CPU O0 recompilation and its host staging
pools have no counterpart here.  It agrees with the refine path to ~1e-13 in
ln Z.  Three fallbacks route to the host-refine path (which still selects on
the card), each logged: ndim > ``DEVICE_NDIM_MAX``, a device-memory plan
over the budget, and a non-finite sum; thin candidate margins retry once
with ``4*pad+8`` candidates.

One ``fast`` estimate (``fast_auto_evidence``, ``fused_auto_evidence``)
runs all in f32: host f64 centring -> upload -> masked-moment whitening,
exact kNN selection at k = kmax and the log-space estimator on the card ->
kmax scalars back (~1e-3 in ln Z of the refine path).  The kernels take
any row count, so nothing is padded to a row bucket.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .estimator import (log_ball_volume_const, log_evidence_from_knn,
                        log_evidence_from_knn_np)
from .knn import _REFINE_CHUNK_BYTES, exact_knn, selector
from .knn_hopper import _padded_width
from .whiten import apply_whiten, whiten_masked, whiten_stats

logger = logging.getLogger(__name__)

# widest chain the device path takes (the JAX package's widest coordinate
# class, ring.GRID_DPAD_CLASSES); wider chains take the host-refine path
DEVICE_NDIM_MAX = 16

# share of the card's free memory the plan may take when no budget is set
_FREE_MEMORY_SHARE = 0.8


def fused_auto_evidence(samples: torch.Tensor, lnlike: torch.Tensor,
                        weights: torch.Tensor, log_prior_volume, *,
                        kmax: int, engine: str = "auto") -> torch.Tensor:
    """Auto-evidence in f32 on the tensors' device, without waiting for it.

    ``samples`` (N, ndim) f32, centred; ``lnlike`` and ``weights`` (N,)
    f32.  Whitening from the moments, the exact selection of kmax
    neighbours (self at column 0) and the estimator on the squared
    distances.  Returns the (kmax,) MLE row (column 0 unused, quirk Q2);
    columns k >= N have no k-th neighbour and are NaN, as on the host
    parity path."""
    n, ndim = samples.shape
    valid = torch.ones(n, dtype=samples.dtype, device=samples.device)
    white, log_j, _ = whiten_masked(samples, valid)
    k_sel = min(kmax, n)
    d2, _ = selector(engine, width=ndim, refine=False)(white, white, k_sel,
                                                       self_mode=True)
    if k_sel < kmax:
        d2 = torch.cat([d2, d2.new_full((n, kmax - k_sel), math.inf)], 1)
    mle = log_evidence_from_knn(
        d2, lnlike, weights, weights.sum(), ndim, log_jacobian=log_j,
        log_prior_volume=log_prior_volume, k_start=1, nsamples=n,
        squared=True)
    k_idx = torch.arange(kmax, device=mle.device)
    return torch.where(k_idx < n, mle, math.nan)


def fast_auto_evidence(samples: np.ndarray, lnlike: np.ndarray,
                       weights: Optional[np.ndarray] = None, *,
                       kmax: int = 5, prior_volume: float = 1.0,
                       sum_adjusted_weights: Optional[float] = None,
                       engine: str = "auto", device="cuda") -> np.ndarray:
    """Host wrapper of ``fused_auto_evidence``: centre in f64, cast to f32,
    run on ``device``, fetch kmax scalars, return k = 1..kmax-1.

    ``sum_adjusted_weights``: importance-adjusted SumW override (quirk Q7);
    applied as a log-shift since only SumW differs from sum(weights)."""
    dev = resolve_device(device)
    kmax = max(2, kmax)
    n = samples.shape[0]
    if weights is None:
        weights = np.ones(n)
    # centre in f64 BEFORE the f32 cast: an uncentred coordinate loses
    # |mean|*2^-24 absolute per element (fatal to the selection ranking of
    # strongly offset chains), and the uncentred-moment covariance cancels
    # at large |mean|/std.  Distances, covariance and Jacobian are all
    # translation-invariant.
    s = np.asarray(samples, np.float64)
    s = s - s.mean(axis=0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mle = fused_auto_evidence(
        f32(s), f32(lnlike), f32(weights),
        torch.tensor(math.log(prior_volume), dtype=torch.float32,
                     device=dev),
        kmax=kmax, engine=engine).cpu().numpy().astype(np.float64)
    if sum_adjusted_weights is not None:
        mle = mle + (np.log(sum_adjusted_weights)
                     - np.log(float(np.sum(weights))))
    # column 0 (the auto-mode self-match) is dropped per quirk Q2
    return mle[1:]


def _gather_chunk_rows(k_sel: int, d: int) -> int:
    """Query rows per refinement chunk: the host refine's chunk budget
    (``MCE_REFINE_CHUNK_MB``) for the diff, its square and the d2 sum, ~3
    live f64 (rows, k_sel, d) buffers."""
    return max(1, _REFINE_CHUNK_BYTES // max(3 * k_sel * d * 8, 1))


def estimate_device_refine_bytes(n: int, n_ref: int, ndim: int, k_sel: int,
                                 cross: bool = False) -> int:
    """Device memory one device-refine estimate plans for, in bytes.

    The f64 coordinates and their f32 copy (the kernel wrapper's copy is
    padded to 8 or 16 columns), the selection's d2 and indices, the f64
    vectors, and ONE chunk of the candidate refinement: the f64 gather is
    chunked over query rows (``_gather_chunk_rows``), so it does not set
    the N ceiling.  ``cross`` must mirror the dispatch (``samples2`` given):
    a second chain gets coordinates of its own even at an equal row
    count."""
    rows = n + (n_ref if cross else 0)
    coords = rows * (ndim * (8 + 4) + _padded_width(ndim) * 4)
    select_out = n * k_sel * (4 + 4)
    vectors = 2 * n * 8
    chunk = min(n, _gather_chunk_rows(k_sel, ndim))
    gather = chunk * k_sel * (3 * ndim * 8 + 2 * 8 + 8)
    return coords + select_out + vectors + gather


def device_budget_bytes(device) -> Optional[int]:
    """The device-memory budget of the plan: ``MCE_DEVICE_HBM_BUDGET_GB``
    when set, else ``_FREE_MEMORY_SHARE`` of the card's free memory
    (``torch.cuda.mem_get_info``).  None on the CPU without the override:
    the host's memory is not planned for."""
    env = os.environ.get("MCE_DEVICE_HBM_BUDGET_GB")
    if env:
        return int(float(env) * 2 ** 30)
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return int(free * _FREE_MEMORY_SHARE)
    return None


def _refine_dotp_post(q64, r64, scal, idx, *, ndim: int, inv_s2: float,
                      kmax: int, self_mode: bool) -> torch.Tensor:
    """Everything after selection, on the card in f64: the candidates' d2,
    the sufficiency statistic, (d2*inv_s2)^(ndim/2)*scal and its sum over
    rows.  Returns [dotp (kmax), thin_count] as one (kmax+1,) f64 tensor.

    Streams over query rows in chunks of ``_gather_chunk_rows``; only the
    (kmax,) sum and the count live across chunks."""
    nq, k_sel = idx.shape
    dev = q64.device
    acc = torch.zeros(kmax, dtype=torch.float64, device=dev)
    thin = torch.zeros((), dtype=torch.float64, device=dev)
    rows = _gather_chunk_rows(k_sel, q64.shape[1])
    for lo in range(0, nq, rows):
        hi = min(nq, lo + rows)
        ic = idx[lo:hi].long()
        diff = q64[lo:hi, None, :] - r64[ic.clamp(min=0)]
        d2 = (diff * diff).sum(-1).masked_fill(ic < 0, math.inf)
        if self_mode:
            own = torch.arange(lo, hi, device=dev)[:, None]
            d2 = d2.masked_fill(ic == own, 0.0)
        d2 = torch.sort(d2, dim=1).values
        if k_sel > kmax:
            # rows whose kmax-th refined d2 sits within the selection's
            # ranking noise of the worst kept candidate; squared distances,
            # so the margin is the square of the host guard's 2^-10
            kth, last = d2[:, kmax - 1], d2[:, -1]
            thin += ((kth > last * (1.0 - 2.0 ** -9)) & torch.isfinite(last)
                     & (last > 0)).sum()
        # (k_sel == kmax: kth IS the boundary; the statistic would be
        # vacuously true for every row and trigger pointless retries)
        z = d2[:, :kmax] * inv_s2
        term = torch.pow(z, 0.5 * ndim) * scal[lo:hi, None]
        acc += torch.where(torch.isfinite(z), term, 0.0).sum(dim=0)
    return torch.cat([acc, thin[None]])


def fused_refine_dotp(q64, r64, scal, n_ref_true, ndim, inv_s2, *,
                      k_sel: int, kmax: int, engine: str = "auto",
                      self_mode: bool = True) -> torch.Tensor:
    """Selection + f64 refinement + reduction of one estimate on the
    coordinates' device.  ``q64``/``r64`` (N, d) f64 whitened coordinates
    (``r64`` is ``q64`` in self mode), ``scal`` (N,) f64.  Returns the
    (kmax+1,) f64 device tensor [dotp_k..., thin_count] without waiting
    for it."""
    q32 = q64.to(torch.float32)
    r32 = q32 if self_mode else r64.to(torch.float32)
    # smalld sweeps exactly the ndim true coordinates (JAX's d_real = ndim)
    _, idx = selector(engine, width=q32.shape[1])(
        q32, r32, k_sel, self_mode=self_mode, nr=n_ref_true)
    return _refine_dotp_post(q64, r64, scal, idx, ndim=ndim, inv_s2=inv_s2,
                             kmax=kmax, self_mode=self_mode)


def fused_refine_dotp_batch(q64, r64, scal, nq, nr, ndims, inv_s2s, *,
                            k_sel: int, kmax: int, engine: str = "auto",
                            self_mode: bool = True) -> torch.Tensor:
    """A batch of estimates in ONE selection launch: ``q64`` (B, Nq, d),
    ``r64`` (B, Nr, d) (``q64`` in self mode), ``scal`` (B, Nq), with the
    per-member counts ``nq``/``nr``, dimensionalities ``ndims`` and scales
    ``inv_s2s`` (sequences of B).  Zero-padded columns past a member's ndim
    add exactly 0 to its distances.  The refinement and reduction run per
    member on its valid rows.  Returns the (B, kmax+1) f64 device tensor."""
    q32 = q64.to(torch.float32)
    r32 = q32 if self_mode else r64.to(torch.float32)
    # smalld sweeps the batch's width, as JAX's batched program sweeps its
    # padded width class
    _, idx = selector(engine, batched=True, width=q32.shape[2])(
        q32, r32, k_sel, self_mode=self_mode, nr=nr, nq=nq)
    return torch.stack([
        _refine_dotp_post(q64[b, :nq[b]], r64[b], scal[b, :nq[b]],
                          idx[b, :nq[b]], ndim=ndims[b], inv_s2=inv_s2s[b],
                          kmax=kmax, self_mode=self_mode)
        for b in range(q64.shape[0])])


def _device_refine_prepare(samples, lnlike, weights, kmax, pad_candidates,
                           samples2=None, device="cuda"):
    """Host prep for the device-resident path; returns (device tensors
    dict, host constants dict).  ``samples2`` switches to cross mode (NNs
    of samples searched in samples2; combined covariance — quirk Q1)."""
    dev = resolve_device(device)
    cross = samples2 is not None
    n, ndim = samples.shape
    s1 = np.asarray(samples, np.float64)

    # Whitening + centring fused into ONE rotation of pre-centred samples:
    # (s - mu) @ (eigvecs/sqrt(ev)) is the whitened-then-centred result, the
    # centred GEMM gives the covariance, and centring before the f32 cast
    # keeps the selection ranking precise for strongly offset chains.
    def _stats_and_rot(x, xc):
        cov = (xc.T @ xc) / max(x.shape[0] - 1.0, 1.0)
        st = whiten_stats(x, cov=cov)
        if not st.posdef:
            return 0.0, None
        return st.log_jacobian, st.eigvecs / np.sqrt(st.eigvals)

    if cross:
        s2 = np.asarray(samples2, np.float64)
        allx = np.concatenate([s1, s2])
        allc = allx - allx.mean(axis=0)
        log_j, rot = _stats_and_rot(allx, allc)
        if rot is None:
            sw, rw = allc[:n], allc[n:]
        else:
            sw = allc[:n] @ rot
            rw = allc[n:] @ rot
            # common re-centre on the reference set (selection precision)
            mu_w = rw.mean(axis=0)
            sw = sw - mu_w
            rw = rw - mu_w
    else:
        s1c = s1 - s1.mean(axis=0)
        log_j, rot = _stats_and_rot(s1, s1c)
        sw = s1c if rot is None else s1c @ rot
    lnl = np.asarray(lnlike, np.float64)
    lnl_max = float(np.max(lnl))
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    # exp(lnL - lnL_max)/w in f64 on the host: the card never evaluates a
    # transcendental of the estimator
    scal = np.exp(lnl - lnl_max) / w
    n_ref = s2.shape[0] if cross else n
    inv_s2 = n_ref ** (2.0 / ndim) / ndim
    k_sel = min(kmax + pad_candidates, n_ref)
    q64 = torch.as_tensor(np.ascontiguousarray(sw), dtype=torch.float64,
                          device=dev)
    tensors = dict(
        q64=q64,
        r64=(torch.as_tensor(np.ascontiguousarray(rw), dtype=torch.float64,
                             device=dev) if cross else q64),
        scal=torch.as_tensor(scal, dtype=torch.float64, device=dev))
    host = dict(n=n, ndim=ndim, lnl_max=lnl_max, cross=cross, log_j=log_j,
                sum_w=float(np.sum(w)), inv_s2=inv_s2, n_ref=n_ref,
                k_sel=k_sel, kmax_eff=min(kmax, k_sel))
    return tensors, host


def _device_refine_finalize(flat, host, kmax, prior_volume,
                            sum_adjusted_weights, warn_thin=True):
    """f64 host bookkeeping around the fetched device result
    [dotp (kmax_eff), thin_count].  Columns beyond kmax_eff (tiny reference
    partitions) come back NaN; a column whose sum is 0 (exact duplicates at
    distance 0 in every row) comes back -inf."""
    flat = np.asarray(flat, np.float64)
    thin_count = flat[-1]
    ke = host["kmax_eff"]
    n, ndim = host["n"], host["ndim"]
    sumw = (host["sum_w"] if sum_adjusted_weights is None
            else float(sum_adjusted_weights))
    k_idx = np.arange(ke)
    # auto: column 0 is the self match; cross: k0=0 semantics — genuine NNs
    # with k_nn = k+1 (reference MCEvidence.py:1120-1123); the caller's
    # slice [1:] drops column 0 either way (quirk Q2)
    k_nn = k_idx + 1 if host["cross"] else k_idx
    with np.errstate(divide="ignore"):
        log_dotp = (np.log(flat[:ke]) - 0.5 * ndim * math.log(host["inv_s2"])
                    + log_ball_volume_const(ndim))
        log_amax = log_dotp - np.log(n * k_nn + 1.0)
    mle = np.full(kmax, np.nan)
    mle[:ke] = (math.log(sumw) + log_amax + host["log_j"] + host["lnl_max"]
                - math.log(prior_volume))
    if warn_thin and thin_count > 0:
        logger.warning(
            "device-refine: %d rows had thin candidate margins (near-tied "
            "neighbour distances); increase pad_candidates or use "
            "precision='refine' if exact tie ordering matters",
            int(thin_count))
    return mle[1:]


def host_refine_evidence(samples, lnlike, weights=None, *, samples2=None,
                         kmax: int = 2, prior_volume: float = 1.0,
                         sum_adjusted_weights=None, engine: str = "auto",
                         device="cuda") -> np.ndarray:
    """The host-refine path as one call (host whitening -> ``exact_knn``,
    which selects on ``device`` and refines on the host -> host f64
    estimator): where the device path falls back to."""
    kmax = max(2, kmax)
    samples = np.asarray(samples, np.float64)
    lnlike = np.asarray(lnlike, np.float64)
    n, ndim = samples.shape
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    cross = samples2 is not None
    allx = np.concatenate([samples, samples2]) if cross else samples
    stats = whiten_stats(allx)
    s1w = apply_whiten(samples, stats)
    s2w = apply_whiten(np.asarray(samples2, np.float64), stats) \
        if cross else None
    dknn = exact_knn(s1w, s2w, kmax, engine=engine, device=device)
    sumw = (float(np.sum(w)) if sum_adjusted_weights is None
            else float(sum_adjusted_weights))
    mle = log_evidence_from_knn_np(
        dknn, lnlike, w, sumw, ndim, log_jacobian=stats.log_jacobian,
        log_prior_volume=math.log(prior_volume),
        k_start=0 if cross else 1, nsamples=n)
    # tiny reference partitions fill only their defined columns; NaN-pad to
    # the kmax-1 contract
    out = np.full(kmax - 1, np.nan)
    out[: len(mle) - 1] = mle[1:]
    return out


def device_refine_evidence(samples: np.ndarray, lnlike: np.ndarray,
                           weights: Optional[np.ndarray] = None, *,
                           samples2: Optional[np.ndarray] = None,
                           kmax: int = 2, prior_volume: float = 1.0,
                           sum_adjusted_weights: Optional[float] = None,
                           pad_candidates: int = 4,
                           engine: str = "auto", device="cuda",
                           _retried: bool = False) -> np.ndarray:
    """Parity-grade evidence with scalar-only device->host traffic.

    Host f64 whitening -> f64 coordinate upload -> selection, f64
    refinement and reduction on ``device`` -> (kmax+1,) fetch -> f64 host
    bookkeeping.  ~1e-13 lnZ of the refine path; returns k = 1..kmax-1
    like ``evidence_fn``.  Cross mode when ``samples2`` is given (NNs of
    ``samples`` searched in ``samples2``).
    """
    kmax = max(2, kmax)
    samples = np.asarray(samples, np.float64)
    fallback = dict(samples2=samples2, kmax=kmax, prior_volume=prior_volume,
                    sum_adjusted_weights=sum_adjusted_weights, engine=engine,
                    device=device)
    if samples.shape[1] > DEVICE_NDIM_MAX:
        logger.info("device-refine: ndim %d > %d (device layout limit); "
                    "falling back to the host refine path",
                    samples.shape[1], DEVICE_NDIM_MAX)
        return host_refine_evidence(samples, lnlike, weights, **fallback)
    dev = resolve_device(device)
    n_ref = (samples2 if samples2 is not None else samples).shape[0]
    k_sel = min(kmax + pad_candidates, n_ref)
    est = estimate_device_refine_bytes(samples.shape[0], n_ref,
                                       samples.shape[1], k_sel,
                                       cross=samples2 is not None)
    budget = device_budget_bytes(dev)
    if budget is not None and est > budget:
        logger.warning(
            "device-refine: planned HBM %.3f GiB (N=%d, k_sel=%d) exceeds "
            "the %.3f GiB budget; falling back to the host refine path "
            "(set MCE_DEVICE_HBM_BUDGET_GB to change the budget)",
            est / 2 ** 30, samples.shape[0], k_sel, budget / 2 ** 30)
        return host_refine_evidence(samples, lnlike, weights, **fallback)
    t, host = _device_refine_prepare(samples, lnlike, weights, kmax,
                                     pad_candidates, samples2=samples2,
                                     device=dev)
    flat = fused_refine_dotp(
        t["q64"], t["r64"], t["scal"], n_ref, host["ndim"], host["inv_s2"],
        k_sel=host["k_sel"], kmax=host["kmax_eff"], engine=engine,
        self_mode=samples2 is None).cpu().numpy()
    if not np.all(np.isfinite(flat[:-1])):
        # (d2*inv_s2)^(ndim/2)*scal left f64 range (far outlier rows): the
        # log-space host path has unlimited range
        logger.warning("device-refine: non-finite sum; falling back to the "
                       "host refine path")
        return host_refine_evidence(samples, lnlike, weights, **fallback)
    # thin-margin guard: moot when every reference row is already a
    # candidate (k_sel == n_ref => the selection is trivially sufficient)
    if flat[-1] > 0 and host["k_sel"] < n_ref:
        retry_pad = 4 * pad_candidates + 8
        if not _retried and min(kmax + retry_pad, n_ref) > host["k_sel"]:
            logger.info("device-refine: thin margins on %d rows; re-running "
                        "with %d extra candidates", int(flat[-1]), retry_pad)
            return device_refine_evidence(
                samples, lnlike, weights, pad_candidates=retry_pad,
                _retried=True, **fallback)
        return _device_refine_finalize(flat, host, kmax, prior_volume,
                                       sum_adjusted_weights, warn_thin=True)
    return _device_refine_finalize(flat, host, kmax, prior_volume,
                                   sum_adjusted_weights, warn_thin=False)


def device_refine_auto_evidence(samples, lnlike, weights=None, **kw):
    """Back-compat alias for the auto-mode device path."""
    return device_refine_evidence(samples, lnlike, weights, **kw)
