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
ln Z.  Three fallbacks route to the host-refine path (host whitening; the
selection and the f64 refine still run on the card), each logged with its
cause and counted as ``device_fallbacks``: ndim past the kernels' widest
layout (``knn_hopper.D_MAX``), a device-memory plan over the budget, and
a non-finite sum; thin candidate margins retry once with ``4*pad+8``
candidates, from the first pass's uploads (count ``device_reruns``).  A
pass is ``device_refine_launch`` and, after the fetch,
``device_refine_finish`` (the grid launches all cells first).  Spans
(``utils/spans.py``): ``device_prep`` (the host f64 prep), ``upload``
(the copies to the card), ``device_run`` (the launches and the wait for
the scalars) and ``reselect`` (the thin-margin re-run, around its own
``device_run``); the counts ``thin_rows`` (the first pass's thin rows),
``device_reruns`` and ``device_fallbacks`` (both counted at 0 on entry,
so that an estimate with none shows them).

One ``fast`` estimate (``fast_auto_evidence``, ``fused_auto_evidence``)
runs all in f32: host f64 centring -> upload -> masked-moment whitening,
kNN selection at k = kmax (exact, or truncated under the packed engines, as
in the JAX package) and the log-space estimator on the card -> kmax scalars
back (~1e-3 in ln Z of the refine path).  The kernels take
any row count, so nothing is padded to a row bucket.
"""

from __future__ import annotations

import logging
import math
import os
from contextlib import ExitStack, nullcontext
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.spans import count, span
from .estimator import (log_ball_volume_const, log_evidence_from_knn,
                        log_evidence_from_knn_np)
from .knn import exact_knn, refine_chunk_rows, refined_d2_chunks, selector
from .knn_hopper import D_MAX, _padded_width
from .whiten import apply_whiten, whiten_masked, whiten_stats

logger = logging.getLogger(__name__)

# share of the card's free memory the plan may take when no budget is set
_FREE_MEMORY_SHARE = 0.8


def fused_auto_evidence(samples: torch.Tensor, lnlike: torch.Tensor,
                        weights: torch.Tensor, log_prior_volume, *,
                        kmax: int, engine: str = "auto") -> torch.Tensor:
    """Auto-evidence in f32 on the tensors' device, without waiting for it.

    ``samples`` (N, ndim) f32, centred; ``lnlike`` and ``weights`` (N,)
    f32.  Whitening from the moments, the ``fast`` path's selection of
    kmax neighbours under ``engine`` (self at column 0) and the estimator on
    the squared distances it returns.  Returns the (kmax,) MLE row (column 0 unused, quirk Q2);
    columns k >= N have no k-th neighbour and are NaN, as on the host
    parity path."""
    n, ndim = samples.shape
    valid = torch.ones(n, dtype=samples.dtype, device=samples.device)
    white, log_j, _ = whiten_masked(samples, valid)
    k_sel = min(kmax, n)
    d2, _ = selector(engine, "fast", width=ndim)(white, white, k_sel,
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


def estimate_device_refine_bytes(n: int, n_ref: int, ndim: int, k_sel: int,
                                 cross: bool = False) -> int:
    """Device memory one device-refine estimate plans for, in bytes.

    The f64 coordinates, their f32 cast and the kernel wrapper's f32 copy
    padded to ``_padded_width(ndim)`` columns (8, 16, 32 or 64; ndim <=
    ``D_MAX``), the selection's d2 and indices, the f64 vectors, and ONE
    chunk of the candidate refinement: the f64 gather is chunked over
    query rows (``refine_chunk_rows``), so it does not set the N
    ceiling.  ``cross`` must mirror the dispatch (``samples2`` given):
    a second chain gets coordinates of its own even at an equal row
    count."""
    rows = n + (n_ref if cross else 0)
    coords = rows * (ndim * (8 + 4) + _padded_width(ndim) * 4)
    select_out = n * k_sel * (4 + 4)
    vectors = 2 * n * 8
    chunk = min(n, refine_chunk_rows(k_sel, ndim))
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
                      kmax: int, self_mode: bool,
                      offset: int = 0) -> torch.Tensor:
    """Everything after selection, on the card in f64: the candidates' d2,
    the sufficiency statistic, (d2*inv_s2)^(ndim/2)*scal and its sum over
    rows.  Returns [dotp (kmax), thin_count] as one (kmax+1,) f64 tensor.
    In self mode query row i is reference row ``offset`` + i (a shard of
    the query rows), whose own candidate is set to distance 0.

    Streams over query rows in the chunks of ``refined_d2_chunks``; only
    the (kmax,) sum and the count live across chunks."""
    k_sel = idx.shape[1]
    dev = q64.device
    acc = torch.zeros(kmax, dtype=torch.float64, device=dev)
    thin = torch.zeros((), dtype=torch.float64, device=dev)
    for lo, hi, d2 in refined_d2_chunks(q64, r64, idx, self_mode=self_mode,
                                        offset=offset):
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
                      self_mode: bool = True, offset: int = 0,
                      kernel_self_pin: bool = True) -> torch.Tensor:
    """Selection + f64 refinement + reduction of one estimate on the
    coordinates' device.  ``q64``/``r64`` (N, d) f64 whitened coordinates
    (``r64`` is ``q64`` in self mode), ``scal`` (N,) f64.  Returns the
    (kmax+1,) f64 device tensor [dotp_k..., thin_count] without waiting
    for it.

    ``kernel_self_pin=False`` (a ring rank's query shard, as JAX's sharded
    program passes it): ``q64`` holds the query rows ``offset`` .. of the
    reference ``r64``, the kernel selects without its self pin (the own
    row wins a slot at distance 0), and the refinement zeroes the own
    candidate by its global row."""
    q32 = q64.to(torch.float32)
    pin = self_mode and kernel_self_pin
    r32 = q32 if pin else r64.to(torch.float32)
    # smalld sweeps exactly the ndim true coordinates (JAX's d_real = ndim)
    _, idx = selector(engine, "device", width=q32.shape[1])(
        q32, r32, k_sel, self_mode=pin, nr=n_ref_true)
    return _refine_dotp_post(q64, r64, scal, idx, ndim=ndim, inv_s2=inv_s2,
                             kmax=kmax, self_mode=self_mode, offset=offset)


def fused_refine_dotp_batch(q64, r64, scal, nq, nr, ndims, inv_s2s, *,
                            k_sel: int, kmax: int, engine: str = "auto",
                            self_mode: bool = True, offset: int = 0,
                            kernel_self_pin: bool = True) -> torch.Tensor:
    """A batch of estimates in ONE selection launch: ``q64`` (B, Nq, d),
    ``r64`` (B, Nr, d) (``q64`` in self mode), ``scal`` (B, Nq), with the
    per-member counts ``nq``/``nr``, dimensionalities ``ndims`` and scales
    ``inv_s2s`` (sequences of B).  Zero-padded columns past a member's ndim
    add exactly 0 to its distances.  The refinement and reduction run per
    member on its valid rows.  ``offset``/``kernel_self_pin`` as in
    ``fused_refine_dotp``, for query shards of the members' reference
    rows.  Returns the (B, kmax+1) f64 device tensor."""
    q32 = q64.to(torch.float32)
    pin = self_mode and kernel_self_pin
    r32 = q32 if pin else r64.to(torch.float32)
    # smalld sweeps the batch's width, as JAX's batched program sweeps its
    # padded width class
    _, idx = selector(engine, "batched", width=q32.shape[2])(
        q32, r32, k_sel, self_mode=pin, nr=nr, nq=nq)
    return torch.stack([
        _refine_dotp_post(q64[b, :nq[b]], r64[b], scal[b, :nq[b]],
                          idx[b, :nq[b]], ndim=ndims[b], inv_s2=inv_s2s[b],
                          kmax=kmax, self_mode=self_mode, offset=offset)
        for b in range(q64.shape[0])])


def _device_refine_prepare(samples, lnlike, weights, kmax, pad_candidates,
                           samples2=None, device="cuda"):
    """Host prep for the device-resident path; returns (device tensors
    dict, host constants dict).  ``samples2`` switches to cross mode (NNs
    of samples searched in samples2; combined covariance — quirk Q1)."""
    dev = resolve_device(device)
    cross = samples2 is not None
    n, ndim = samples.shape
    with span("device_prep"):
        s1 = np.asarray(samples, np.float64)

        # Whitening + centring fused into ONE rotation of pre-centred
        # samples: (s - mu) @ (eigvecs/sqrt(ev)) is the whitened-then-centred
        # result, the centred GEMM gives the covariance, and centring before
        # the f32 cast keeps the selection ranking precise for strongly
        # offset chains.
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
                # common re-centre on the reference set (selection
                # precision)
                mu_w = rw.mean(axis=0)
                sw = sw - mu_w
                rw = rw - mu_w
            rw = np.ascontiguousarray(rw)
        else:
            s1c = s1 - s1.mean(axis=0)
            log_j, rot = _stats_and_rot(s1, s1c)
            sw = s1c if rot is None else s1c @ rot
        sw = np.ascontiguousarray(sw)
        lnl = np.asarray(lnlike, np.float64)
        lnl_max = float(np.max(lnl))
        w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
        # exp(lnL - lnL_max)/w in f64 on the host: the card never evaluates
        # a transcendental of the estimator
        scal = np.exp(lnl - lnl_max) / w
    n_ref = s2.shape[0] if cross else n
    inv_s2 = n_ref ** (2.0 / ndim) / ndim
    k_sel = min(kmax + pad_candidates, n_ref)
    with span("upload"):
        q64 = torch.as_tensor(sw, dtype=torch.float64, device=dev)
        tensors = dict(
            q64=q64,
            r64=(torch.as_tensor(rw, dtype=torch.float64, device=dev)
                 if cross else q64),
            scal=torch.as_tensor(scal, dtype=torch.float64, device=dev))
    host = dict(n=n, ndim=ndim, lnl_max=lnl_max, cross=cross, log_j=log_j,
                sum_w=float(np.sum(w)), inv_s2=inv_s2, n_ref=n_ref,
                k_sel=k_sel, kmax=kmax, kmax_eff=min(kmax, k_sel))
    return tensors, host


def device_refine_launch(samples, lnlike, weights=None, *, samples2=None,
                         kmax: int = 2, pad_candidates: int = 4,
                         engine: str = "auto", device="cuda",
                         wait: bool = False):
    """Prep, upload and ``fused_refine_dotp`` of one chain (or cross pair)
    at k_sel = kmax + pad.  Returns (flat, tensors, plan): [dotp...,
    thin_count] on the device, not waited for (with ``wait`` fetched, the
    launch and the wait under ``device_run``), the uploads, the constants."""
    t, plan = _device_refine_prepare(samples, lnlike, weights, kmax,
                                     pad_candidates, samples2=samples2,
                                     device=device)
    return _device_refine_pass(t, plan, engine=engine, wait=wait), t, plan


def _device_refine_pass(t, plan, *, engine: str, wait: bool):
    """``fused_refine_dotp`` of uploaded tensors ``t`` at the ``plan``'s
    k_sel: [dotp..., thin_count] on the device, not waited for, or with
    ``wait`` fetched as numpy (the launch and the wait under
    ``device_run``)."""
    with span("device_run") if wait else nullcontext():
        flat = fused_refine_dotp(
            t["q64"], t["r64"], t["scal"], plan["n_ref"], plan["ndim"],
            plan["inv_s2"], k_sel=plan["k_sel"], kmax=plan["kmax_eff"],
            engine=engine, self_mode=not plan["cross"])
        if wait:
            flat = flat.cpu().numpy()
    return flat


THIN, NONFINITE = "thin", "non-finite"


def device_refine_finish(flat, plan, *, prior_volume: float = 1.0,
                         sum_adjusted_weights: Optional[float] = None,
                         last: bool = False):
    """The ln Z row (k = 1..kmax-1) of a fetched pass ``flat`` under its
    ``plan``, or ``NONFINITE`` (a sum left f64 range), or ``THIN`` (thin
    candidate margins) unless ``last``: a last thin pass warns where
    k_sel < n_ref.  Columns beyond kmax_eff (tiny reference partitions)
    come back NaN; a column whose sum is 0 (exact duplicates at distance 0
    in every row) comes back -inf."""
    flat = np.asarray(flat, np.float64)
    if not np.all(np.isfinite(flat[:-1])):
        return NONFINITE
    thin_count = flat[-1]
    if thin_count > 0 and not last:
        return THIN
    kmax, ke = plan["kmax"], plan["kmax_eff"]
    n, ndim = plan["n"], plan["ndim"]
    sumw = (plan["sum_w"] if sum_adjusted_weights is None
            else float(sum_adjusted_weights))
    k_idx = np.arange(ke)
    # auto: column 0 is the self match; cross: k0=0 semantics — genuine NNs
    # with k_nn = k+1 (reference MCEvidence.py:1120-1123); the caller's
    # slice [1:] drops column 0 either way (quirk Q2)
    k_nn = k_idx + 1 if plan["cross"] else k_idx
    with np.errstate(divide="ignore"):
        log_dotp = (np.log(flat[:ke]) - 0.5 * ndim * math.log(plan["inv_s2"])
                    + log_ball_volume_const(ndim))
        log_amax = log_dotp - np.log(n * k_nn + 1.0)
    mle = np.full(kmax, np.nan)
    mle[:ke] = (math.log(sumw) + log_amax + plan["log_j"] + plan["lnl_max"]
                - math.log(prior_volume))
    if thin_count > 0 and plan["k_sel"] < plan["n_ref"]:
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
                           engine: str = "auto", device="cuda") -> np.ndarray:
    """Parity-grade evidence with scalar-only device->host traffic.

    Host f64 whitening -> f64 coordinate upload -> selection, f64
    refinement and reduction on ``device`` -> (kmax+1,) fetch -> f64 host
    bookkeeping.  ~1e-13 lnZ of the refine path; returns k = 1..kmax-1
    like ``evidence_fn``.  Cross mode when ``samples2`` is given (NNs of
    ``samples`` searched in ``samples2``).  A thin pass (some row's
    kmax-th candidate within the selection's noise of the last) counts
    its rows as ``thin_rows`` and runs once more with 4*pad+8 candidates,
    under the ``reselect`` span, from the first pass's uploads (count
    ``device_reruns``): the host prep and the upload run once.  An estimate
    handed to ``host_refine_evidence`` (ndim > ``D_MAX``, a plan over the
    budget, a non-finite sum) counts ``device_fallbacks``."""
    kmax = max(2, kmax)
    samples = np.asarray(samples, np.float64)
    n, ndim = samples.shape
    n_ref = (samples if samples2 is None else samples2).shape[0]
    count("device_fallbacks", 0)
    count("device_reruns", 0)

    def fallback(cause, level=logging.WARNING):
        logger.log(level, "device-refine: %s; falling back to the host "
                   "refine path", cause)
        count("device_fallbacks")
        return host_refine_evidence(
            samples, lnlike, weights, samples2=samples2, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights, engine=engine,
            device=device)

    if ndim > D_MAX:
        return fallback(f"ndim {ndim} > {D_MAX} (the kernels' widest "
                        f"layout)", logging.INFO)
    dev = resolve_device(device)
    t = None
    with ExitStack() as retry:
        for pad in (pad_candidates, 4 * pad_candidates + 8):
            k_sel = min(kmax + pad, n_ref)
            est = estimate_device_refine_bytes(n, n_ref, ndim, k_sel,
                                               cross=samples2 is not None)
            budget = device_budget_bytes(dev)
            if budget is not None and est > budget:
                cause = (f"planned HBM {est / 2 ** 30:.3f} GiB (N={n}, "
                         f"k_sel={k_sel}) exceeds the {budget / 2 ** 30:.3f} "
                         f"GiB budget (set MCE_DEVICE_HBM_BUDGET_GB to change "
                         f"the budget)")
                break
            if t is None:
                t, plan = _device_refine_prepare(
                    samples, lnlike, weights, kmax, pad, samples2=samples2,
                    device=dev)
            else:
                plan = dict(plan, k_sel=k_sel, kmax_eff=min(kmax, k_sel))
            flat = _device_refine_pass(t, plan, engine=engine, wait=True)
            # the retry, or every reference row already a candidate
            row = device_refine_finish(
                flat, plan, prior_volume=prior_volume,
                sum_adjusted_weights=sum_adjusted_weights,
                last=pad != pad_candidates or k_sel >= n_ref)
            if row is NONFINITE:
                # (d2*inv_s2)^(ndim/2)*scal left f64 range (far outlier
                # rows): the log-space host path has unlimited range
                cause = "non-finite sum"
                break
            if row is not THIN:
                return row
            count("thin_rows", int(flat[-1]))
            count("device_reruns")
            logger.info("device-refine: thin margins on %d rows; re-running "
                        "with %d extra candidates", int(flat[-1]),
                        4 * pad + 8)
            retry.enter_context(span("reselect"))
        # a fallback after a thin first pass runs inside ``reselect``
        return fallback(cause)


def device_refine_auto_evidence(samples, lnlike, weights=None, **kw):
    """Back-compat alias for the auto-mode device path."""
    return device_refine_evidence(samples, lnlike, weights, **kw)
