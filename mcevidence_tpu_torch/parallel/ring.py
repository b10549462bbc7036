"""Many chains in one batch on one device: the grid programs.

The counterpart of the grid functions of ``mcevidence_tpu/parallel/ring.py``,
which run a batch of chains data-parallel over the ``dp`` axis of a device
mesh and shard each chain's rows around its ``ring`` axis.  There is no mesh
here: one card takes a whole batch of chains in one selection launch,
``knn_select_batched`` (the counterpart of the TPU kernel K5), with each
member's true row counts as runtime values, so neither the batch nor the
rows are padded to compile buckets, and self mode uses the kernel's own pin.
The JAX names are kept so that a reader finds the counterparts; the
multi-GPU ring is ROADMAP.md Queue 1, item 10.  The engine picks the batched
selection as ``ops.knn.selector`` maps it: ``pallas_packed`` takes
``knn_select_packed`` (K7's counterpart) on the device and refine batches,
and the fast program takes the exact batched selection under every engine
but ``torch``, as the JAX package's takes no engine.

* ``sharded_grid_auto_evidence``: ``fast`` precision — the body of
  ``make_sharded_grid_evidence`` at dp = ring = 1 as batched tensors:
  masked f32 whitening per chain, one batched selection, the batched
  log-space reduction and the per-chain SumW shift, all on the card,
  (B, kmax) scalars back.  Unlike the JAX program, each chain is centred
  in f64 on the host first (as ``fast_auto_evidence`` does): the same
  function, without the cancellation of uncentred f32 moments.
* ``sharded_grid_device_refine_evidence``: ``device`` precision — host f64
  whitening per chain, one batched selection, f64 refinement and reduction
  on the card, (B, kmax+1) scalars back.
* ``sharded_grid_evidence_refine``: ``refine`` precision — host f64
  whitening per chain, batched selection, the candidate indices back, host
  f64 refinement with the sufficiency guard (its reselect runs
  ``knn_select_cuda`` per chain), host f64 estimator.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..ops.estimator import log_evidence_from_knn, log_evidence_from_knn_np
from ..ops.knn import center_f64, guarded_refine_knn_f64, selector
from ..ops.pipeline import (_device_refine_finalize, fused_refine_dotp_batch,
                            host_refine_evidence)
from ..ops.whiten import apply_whiten, whiten_masked, whiten_stats
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

# Coordinate-width classes of the JAX grid programs, kept as the grid
# driver's chunking key: the CUDA kernels pad to the same widths (8, 16).
GRID_DPAD_CLASSES = (8, 16)
GRID_DPAD = GRID_DPAD_CLASSES[-1]


def _dpad_class(ndim: int) -> int:
    for w in GRID_DPAD_CLASSES:
        if ndim <= w:
            return w
    raise ValueError(f"ndim {ndim} > GRID_DPAD {GRID_DPAD}")


# Chains per batched launch in the grid driver's chunks and in
# sharded_grid_evidence_refine.
GRID_BATCH_QUANTUM = 4


def _normalize_chains(chains):
    norm = []
    for c in chains:
        if isinstance(c, dict):
            s = np.asarray(c["samples"], np.float64)
            lnl = np.asarray(c["loglikes"], np.float64)
            w = np.asarray(c.get("weights", np.ones(len(s))), np.float64)
        else:
            s = np.asarray(c[0], np.float64)
            lnl = np.asarray(c[1], np.float64)
            w = (np.asarray(c[2], np.float64) if len(c) > 2
                 else np.ones(len(s)))
        norm.append((s, lnl, w))
    return norm


def _grid_batch_layout(norm):
    """(b_true, b_pad, n_pad, ndim) of a batch on one card: the batch and
    the rows are not padded (the kernels take per-member counts), so
    b_pad = b_true and n_pad is the longest chain; ndim is the widest
    chain's (narrower chains are zero-padded, which adds exactly 0 to
    their distances)."""
    b_true = len(norm)
    return (b_true, b_true, max(s.shape[0] for s, _, _ in norm),
            max(s.shape[1] for s, _, _ in norm))


def _references(chains2, b_true):
    refs = [np.asarray(s2, np.float64) for s2 in chains2]
    if len(refs) != b_true:
        raise ValueError("chains2 must match chains 1:1")
    return refs


def _whiten_chain(s, ref):
    """Host f64 whitening of one chain (combined s1+s2 covariance in cross
    mode — covtype='all', quirk Q1), then centring on the reference set in
    f64, which keeps the f32 selection ranking precise for strongly offset
    coordinates.  Returns (stats, query, ref or None)."""
    if ref is None:
        stats = whiten_stats(s)
        sw, _ = center_f64(apply_whiten(s, stats), None)
        return stats, sw, None
    stats = whiten_stats(np.concatenate([s, ref]))
    sw, rw = center_f64(apply_whiten(s, stats), apply_whiten(ref, stats))
    return stats, sw, rw


def _stacked(arrays, rows, width, dtype):
    """Zero-padded (B, rows, width) host stack of (n_b, d_b) arrays."""
    out = np.zeros((len(arrays), rows, width), dtype)
    for b, a in enumerate(arrays):
        out[b, :a.shape[0], :a.shape[1]] = a
    return out


def sharded_grid_auto_evidence(chains, *, kmax: int = 2,
                               prior_volumes=None, sumw_log_shifts=None,
                               engine: str = "auto",
                               device="cuda") -> np.ndarray:
    """Auto evidence for a batch of chains in ``fast`` precision (f32).

    ``chains``: a sequence of (samples, lnlike[, weights]) tuples (or dicts
    with those keys) of one dimensionality.  Each chain is centred in f64
    on the host and cast to f32; on ``device`` the batch is whitened from
    each member's masked moments, searched by ONE batched selection of
    kmax neighbours with each member's row count, and reduced per member
    (``_reduce_mle``'s semantics); ``sumw_log_shifts`` are the per-chain
    ln(SumW_adj / SumW) of an importance reweighting (quirk Q7).  Returns
    (len(chains), kmax-1) ln Z values."""
    kmax = max(2, kmax)
    dev = resolve_device(device)
    norm = _normalize_chains(chains)
    b_true, _, n_rows, ndim = _grid_batch_layout(norm)
    if any(s.shape[1] != ndim for s, _, _ in norm):
        raise ValueError("sharded_grid_auto_evidence takes chains of one "
                         "dimensionality")
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)
    shifts = (np.zeros(b_true) if sumw_log_shifts is None
              else np.asarray(sumw_log_shifts, np.float64))
    ns = [s.shape[0] for s, _, _ in norm]
    samples = np.zeros((b_true, n_rows, ndim))
    lnl = np.full((b_true, n_rows), -1e30)
    w = np.ones((b_true, n_rows))
    valid = np.zeros((b_true, n_rows))
    for i, (s, l, wt) in enumerate(norm):
        samples[i, :ns[i]] = s - s.mean(axis=0)
        lnl[i, :ns[i]] = l
        w[i, :ns[i]] = wt
        valid[i, :ns[i]] = 1.0

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    S, L, W, V = f32(samples), f32(lnl), f32(w), f32(valid)
    white, log_j, _ = whiten_masked(S, V)
    k_sel = min(kmax, n_rows)
    d2, _ = selector(engine, "grid_fast", width=ndim)(
        white, white, k_sel, self_mode=True, nr=ns, nq=ns)
    if k_sel < kmax:
        d2 = torch.cat([d2, d2.new_full((b_true, n_rows, kmax - k_sel),
                                        math.inf)], dim=2)
    mle = log_evidence_from_knn(
        d2, L, W, (W * V).sum(dim=1), ndim, log_jacobian=log_j,
        log_prior_volume=f32(np.log(prior_volumes)), k_start=1,
        nsamples=f32(ns), valid=V, squared=True)
    # importance reweighting enters only through SumW (quirk Q7), as a
    # per-chain log shift of every column past the self match
    mle = mle.cpu().numpy().astype(np.float64)
    return mle[:, 1:] + shifts[:, None]


def sharded_grid_device_refine_evidence(chains, *, kmax: int = 2,
                                        prior_volumes=None,
                                        sum_adjusted_weights=None,
                                        chains2=None,
                                        pad_candidates: int = 4,
                                        engine: str = "auto",
                                        device="cuda",
                                        defer: bool = False):
    """Parity-grade batched evidence with scalars-only device->host
    traffic: host f64 whitening per chain, one upload of the batch's f64
    coordinates, ONE batched selection launch, f64 refinement and reduction
    on ``device``, f64 host bookkeeping.  Auto mode, or cross mode when
    ``chains2`` is a matching sequence of reference-partition sample arrays
    (combined covariance — quirk Q1; k0=0 semantics).  Chains may mix
    dimensionalities up to ``GRID_DPAD``.  Returns (len(chains), kmax-1) at
    ~1e-13 lnZ of the refine path.

    Thin candidate margins re-run the batch with 4*pad+8 candidates while
    pad < 32 (k_sel = kmax+4, then kmax+24, then kmax+104: on the card the
    last retry raises above kmax = 152, the large-k kernel's k <= 256).  A
    chain whose sum is not finite takes the host-refine path.

    ``defer=True`` returns a zero-argument finalize callable instead: the
    batch is launched at once, but the fetch (and any retry) waits until
    the callable runs, so a driver can launch many batches back to back.
    """
    kmax = max(2, kmax)
    dev = resolve_device(device)
    norm = _normalize_chains(chains)
    b_true, _, n_rows, width = _grid_batch_layout(norm)
    _dpad_class(width)          # raises past GRID_DPAD
    cross = chains2 is not None
    refs = _references(chains2, b_true) if cross else None
    n_refs = ([r.shape[0] for r in refs] if cross
              else [s.shape[0] for s, _, _ in norm])
    if min(n_refs) <= kmax:
        raise ValueError(f"reference partitions shorter than kmax+1="
                         f"{kmax + 1} rows are not supported by the batched "
                         "device-refine path; use evidence_fn per chain")
    # cap by the LARGEST reference partition: the batched selection gives a
    # shorter member absent slots past its own count, so a small chain must
    # not starve the large chains of candidates nor disable their retry
    k_sel = min(kmax + pad_candidates, max(n_refs))
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)

    queries, references, scals, hosts = [], [], [], []
    for i, (s, lnl, w) in enumerate(norm):
        n, d = s.shape
        stats, sw, rw = _whiten_chain(s, refs[i] if cross else None)
        queries.append(sw)
        if cross:
            references.append(rw)
        lnl_max = float(np.max(lnl))
        scals.append(np.exp(lnl - lnl_max) / w)
        hosts.append(dict(n=n, ndim=d, lnl_max=lnl_max, cross=cross,
                          log_j=stats.log_jacobian, sum_w=float(np.sum(w)),
                          inv_s2=n_refs[i] ** (2.0 / d) / d,
                          n_ref=n_refs[i], k_sel=k_sel, kmax_eff=kmax))
    q64 = torch.as_tensor(_stacked(queries, n_rows, width, np.float64),
                          device=dev)
    r64 = (torch.as_tensor(_stacked(references, max(n_refs), width,
                                    np.float64), device=dev)
           if cross else q64)
    scal = torch.as_tensor(
        _stacked([x[:, None] for x in scals], n_rows, 1, np.float64)[..., 0],
        device=dev)
    parts_dev = fused_refine_dotp_batch(
        q64, r64, scal, [h["n"] for h in hosts], n_refs,
        [h["ndim"] for h in hosts], [h["inv_s2"] for h in hosts],
        k_sel=k_sel, kmax=kmax, engine=engine, self_mode=not cross)

    def _finalize() -> np.ndarray:
        parts = parts_dev.cpu().numpy()
        thin = parts[:, -1].sum()
        if thin > 0:
            retry_pad = 4 * pad_candidates + 8
            if (pad_candidates < 32
                    and min(kmax + retry_pad, max(n_refs)) > k_sel):
                logger.info("grid device-refine: thin margins on %d rows; "
                            "re-running with %d extra candidates",
                            int(thin), retry_pad)
                return sharded_grid_device_refine_evidence(
                    chains, kmax=kmax, prior_volumes=prior_volumes,
                    sum_adjusted_weights=sum_adjusted_weights,
                    chains2=chains2, pad_candidates=retry_pad,
                    engine=engine, device=dev)
            logger.warning(
                "grid device-refine: %d rows had thin candidate margins "
                "(near-tied neighbour distances) and the candidate set "
                "cannot be widened further; use sharded_grid_evidence_"
                "refine if exact tie ordering matters", int(thin))
        out = np.zeros((b_true, kmax - 1))
        for i in range(b_true):
            sw_i = (None if sum_adjusted_weights is None
                    else float(sum_adjusted_weights[i]))
            if not np.all(np.isfinite(parts[i, :-1])):
                logger.warning("grid device-refine: non-finite sum on chain "
                               "%d; host-refine fallback", i)
                s, lnl, w = norm[i]
                out[i] = host_refine_evidence(
                    s, lnl, w, samples2=refs[i] if cross else None,
                    kmax=kmax, prior_volume=float(prior_volumes[i]),
                    sum_adjusted_weights=sw_i, engine=engine, device=dev)
                continue
            flat = np.concatenate([parts[i, :-1], [0.0]])
            out[i] = _device_refine_finalize(flat, hosts[i], kmax,
                                             float(prior_volumes[i]), sw_i,
                                             warn_thin=False)
        return out

    if defer:
        return _finalize
    return _finalize()


def sharded_grid_evidence_refine(chains, *, kmax: int = 2,
                                 prior_volumes=None,
                                 sum_adjusted_weights=None,
                                 chains2=None,
                                 pad_candidates: int = 4,
                                 engine: str = "auto",
                                 device="cuda") -> np.ndarray:
    """Parity-grade batched evidence in ``refine`` precision: host f64
    whitening per chain, batched f32 selection of each width class in
    chunks of ``GRID_BATCH_QUANTUM`` chains (every chunk launched before
    any is fetched), host f64 candidate refinement with the sufficiency
    guard and host f64 estimator.  Returns (len(chains), kmax-1).

    Auto mode when ``chains2`` is None; cross mode when it is a matching
    sequence of reference-partition sample arrays (per-chain NNs of s1
    searched in s2, k0=0 semantics; combined s1+s2 covariance — quirk Q1).
    """
    kmax = max(2, kmax)
    dev = resolve_device(device)
    norm = _normalize_chains(chains)
    b_true = len(norm)
    ndims = [s.shape[1] for s, _, _ in norm]
    # the stacks below are a width class wide (8 or 16 columns)
    select_batch = selector(engine, "batched", width=GRID_DPAD)
    select = selector(engine, "refine", width=GRID_DPAD)
    ns = [s.shape[0] for s, _, _ in norm]
    if max(ndims) > GRID_DPAD:
        raise ValueError(f"ndim {max(ndims)} > GRID_DPAD {GRID_DPAD}")
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)
    cross = chains2 is not None
    refs = _references(chains2, b_true) if cross else None
    n_refs = [r.shape[0] for r in refs] if cross else ns
    k_sel = min(kmax + pad_candidates, max(n_refs))
    whitened = [_whiten_chain(s, refs[i] if cross else None)
                for i, (s, _, _) in enumerate(norm)]

    by_class: dict = {}
    for i in range(b_true):
        by_class.setdefault(_dpad_class(ndims[i]), []).append(i)
    pending = []
    for dpad, indices in by_class.items():
        for c0 in range(0, len(indices), GRID_BATCH_QUANTUM):
            members = indices[c0:c0 + GRID_BATCH_QUANTUM]
            q = torch.as_tensor(_stacked(
                [whitened[i][1] for i in members],
                max(ns[i] for i in members), dpad, np.float32), device=dev)
            r = q if not cross else torch.as_tensor(_stacked(
                [whitened[i][2] for i in members],
                max(n_refs[i] for i in members), dpad, np.float32),
                device=dev)
            _, idx = select_batch(q, r, k_sel, self_mode=not cross,
                                  nr=[n_refs[i] for i in members],
                                  nq=[ns[i] for i in members])
            pending.append((members, q, r, idx))
    cands = [None] * b_true
    for members, q, r, idx in pending:
        idx = idx.cpu().numpy()
        for b, i in enumerate(members):
            q_i = q[b, :ns[i]]
            cands[i] = (idx[b, :ns[i]], q_i,
                        r[b, :n_refs[i]] if cross else q_i)

    out = np.full((b_true, kmax - 1), np.nan)
    for i, (s, lnl, w) in enumerate(norm):
        stats, sw, rw = whitened[i]
        idx, q32, r32 = cands[i]

        def reselect(ks, _q=q32, _r=r32):
            return select(_q, _r, ks, self_mode=not cross)[1].cpu().numpy()

        dknn = guarded_refine_knn_f64(
            sw, rw if cross else sw, idx, min(kmax, n_refs[i]),
            self_mode=not cross, reselect=reselect)
        sumw = (float(np.sum(w)) if sum_adjusted_weights is None
                else float(sum_adjusted_weights[i]))
        mle = log_evidence_from_knn_np(
            dknn, lnl, w, sumw, ndims[i],
            log_jacobian=stats.log_jacobian,
            log_prior_volume=math.log(prior_volumes[i]),
            k_start=0 if cross else 1, nsamples=s.shape[0])
        # a tiny reference partition fills only its first columns; the rest
        # stay NaN, as on the device path
        out[i, : len(mle) - 1] = mle[1:]
    return out
