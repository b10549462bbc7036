"""Exact k-nearest-neighbour distances: f32 selection on the card, f64 refine.

The counterpart of ``mcevidence_tpu/ops/knn.py``:

* selection: the reference-set-centred f64 coordinates are cast to f32 and
  k_sel = k + pad candidates per row are selected on ``device``.
* refinement (``refine=True``, the default): only the candidates' indices
  come back to the host; their distances are recomputed in f64 with the
  cancellation-free difference form and re-sorted, and a sufficiency guard
  re-selects once with 4*k_sel+8 candidates when the k-th refined distance
  sits within 2^-10 of the candidate boundary.
* ``refine=False`` (the ``fast`` precision): k candidates are selected by
  the exact dispatch and the square roots of their f32 d2 come back as f64.

Engines (``engine=``):

* ``"auto"``, ``"cuda"`` (alias ``"pallas"``) and ``"pallas_exact"``: the
  exact k-dependent kernel dispatch, small-k kernel below 14 candidates and
  large-k kernel from there (``pallas_exact`` is K4's forced engine in the
  JAX package; every kernel here is exact, so it takes the same dispatch).
  On a CPU device the kernel wrappers run their plain version.
* ``"pallas_smalld"``: the small-d kernel (K8/K9's counterpart) where the
  JAX package runs it, refine consumers with d <= 16; wider inputs take the
  exact dispatch, and so does ``refine=False``.
* ``"torch"`` (alias ``"xla"``): the plain PyTorch selection.

Auto-evidence ("self mode", ``ref=None``) keeps the reference's semantics:
the query point itself is neighbour 0 at distance exactly 0.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .knn_hopper import (SMALLD_MAX, knn_select_batched, knn_select_cuda,
                         knn_select_smalld, knn_select_torch,
                         knn_select_torch_batched)

logger = logging.getLogger(__name__)

BUCKET_QUANTUM = 512


def bucket_size(n: int, quantum: int = BUCKET_QUANTUM) -> int:
    """Smallest row bucket >= n on the {1,1.25,1.5,1.75} x 2^j x quantum
    grid.  The CUDA kernels take any row count, so nothing is padded to it:
    the grid driver groups cells by it into chunks."""
    if n <= quantum:
        return quantum
    j = int(math.floor(math.log2(n / quantum)))
    base = quantum * (1 << j)
    for m in (1.0, 1.25, 1.5, 1.75, 2.0):
        b = int(base * m)
        if b >= n:
            return b
    return 2 * base  # unreachable


def bucket_size_pow2(n: int, quantum: int = BUCKET_QUANTUM) -> int:
    """Power-of-two row bucket (>= n), the grid driver's chunking key in
    ``device`` precision."""
    b = quantum
    while b < n:
        b *= 2
    return b


# forced single-kernel engines of the JAX package and the ROADMAP kernel
# each one waits for
_PENDING_ENGINES = {
    "pallas_packed": "K6 (_knn_kernel_packed)",
    "pallas_packed2": "K1 as a forced engine (K1 runs only behind the "
                      "k-dependent 'cuda' dispatch)",
    "pallas_binned": "K2/K3 as a forced engine (they run only behind the "
                     "k-dependent 'cuda' dispatch)",
}
ENGINES = (("auto", "cuda", "pallas", "pallas_exact", "pallas_smalld",
            "torch", "xla") + tuple(_PENDING_ENGINES))


def resolve_engine(engine: str) -> str:
    """Map an engine name onto ``"cuda"`` (the exact dispatch),
    ``"smalld"`` or ``"torch"``; raises for names whose kernel is not
    ported yet and for unknown names."""
    if engine in ("auto", "cuda", "pallas", "pallas_exact"):
        return "cuda"
    if engine == "pallas_smalld":
        return "smalld"
    if engine in ("torch", "xla"):
        return "torch"
    if engine in _PENDING_ENGINES:
        raise ValueError(
            f"engine {engine!r} is not ported yet: it waits for the TPU "
            f"kernel {_PENDING_ENGINES[engine]} (ROADMAP.md, Queue 2); use "
            "'auto', 'cuda', 'pallas_exact', 'pallas_smalld' or 'torch'")
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


def selector(engine: str, batched: bool = False, *, width: int,
             refine: bool = True):
    """The selection an engine runs on rows ``width`` coordinates wide: the
    plain version for ``"torch"``; the small-d kernel for ``"smalld"`` when
    a refine stage consumes the candidates (``refine``) and ``width`` <=
    ``SMALLD_MAX``, as the JAX package dispatches it; the exact kernel
    dispatch otherwise.  ``batched`` picks the (B, N, d) forms."""
    kind = resolve_engine(engine)
    if kind == "torch":
        return knn_select_torch_batched if batched else knn_select_torch
    if kind == "smalld" and refine and width <= SMALLD_MAX:
        return knn_select_smalld
    return knn_select_batched if batched else knn_select_cuda


def center_f64(query64: np.ndarray,
               ref64: Optional[np.ndarray] = None):
    """Subtract the reference-set mean in f64 from both sets.

    Distances are translation-invariant, but a later f64->f32 cast loses
    |offset|*2^-24 absolute precision per coordinate — fatal for the f32
    selection ranking of strongly offset chains (whitening does not remove
    the mean; reference behaviour).  Returns (q_centred, r_centred) where
    r_centred is q_centred in self mode (``ref64=None``)."""
    q = np.asarray(query64, np.float64)
    r = q if ref64 is None else np.asarray(ref64, np.float64)
    mu = np.mean(r, axis=0)
    q = q - mu
    r = q if ref64 is None else r - mu
    return q, r


def guarded_refine_knn_f64(query64, ref64, idx, k, *, self_mode,
                           reselect=None, _retried=False) -> np.ndarray:
    """f64 candidate refinement + the candidate-sufficiency guard.

    Refines all candidates in ``idx`` and checks that the k-th refined
    distance sits inside the candidate boundary by more than the f32/packed
    ranking noise (~2^-11 relative); on a thin margin, calls
    ``reselect(k_sel)`` once for a larger candidate set, then warns
    (near-exact ties leave the evidence unchanged to O(tie gap)).
    """
    d_all = _refine_knn_f64_all(query64, ref64, idx, self_mode)
    d = d_all[:, :k]
    if d_all.shape[1] > k:
        boundary = d_all[:, -1]
        thin = ((d[:, k - 1] > boundary * (1.0 - 2.0 ** -10))
                & np.isfinite(boundary) & (boundary > 0))
        if thin.any():
            if reselect is not None and not _retried:
                k_sel = d_all.shape[1]
                logger.info(
                    "kNN candidate margin thin for %d/%d rows; re-selecting "
                    "with %d candidates", int(thin.sum()), len(d),
                    min(4 * k_sel + 8, ref64.shape[0]))
                idx2 = reselect(min(4 * k_sel + 8, ref64.shape[0]))
                return guarded_refine_knn_f64(query64, ref64, idx2, k,
                                              self_mode=self_mode,
                                              reselect=reselect,
                                              _retried=True)
            logger.warning(
                "kNN candidate margin thin for %d/%d rows (near-tied "
                "neighbour distances); parity may be limited by genuine "
                "ties, which leave the evidence unchanged to O(tie gap)",
                int(thin.sum()), len(d))
    return d


def refine_knn_f64(query64: np.ndarray, ref64: np.ndarray,
                   idx: np.ndarray, k: int,
                   self_mode: bool = False) -> np.ndarray:
    """Exact float64 distances for pre-selected candidates (host, numpy).

    Recomputes ||q - r||^2 with the difference form for every candidate in
    ``idx`` (Nq, k_sel >= k), re-sorts, and returns the k smallest distances
    per row as float64.  Cost is O(Nq * k_sel * d) — negligible next to the
    O(N^2 d) selection sweep.
    """
    return _refine_knn_f64_all(query64, ref64, idx, self_mode)[:, :k]


# peak host memory one refinement chunk may use for its (rows, k_sel, d)
# f64 workspace; chunking over query rows keeps the host refine flat in RAM
_REFINE_CHUNK_BYTES = int(float(os.environ.get(
    "MCE_REFINE_CHUNK_MB", "256")) * 2 ** 20)


def _refine_knn_f64_all(query64, ref64, idx, self_mode) -> np.ndarray:
    """All candidate distances, refined in f64 and sorted ascending.

    Streams over query rows in ~_REFINE_CHUNK_BYTES chunks: the (rows,
    k_sel, d) difference workspace is the refine path's only
    N-proportional host allocation."""
    idx = np.asarray(idx)
    nq, k_sel = idx.shape
    d = query64.shape[1]
    # diff + einsum intermediates: ~3 live f64 buffers of (chunk, k_sel, d)
    rows_per_chunk = max(1, _REFINE_CHUNK_BYTES // max(3 * k_sel * d * 8, 1))
    out = np.empty((nq, k_sel), np.float64)
    for lo in range(0, nq, rows_per_chunk):
        hi = min(nq, lo + rows_per_chunk)
        ic = idx[lo:hi]
        safe = np.maximum(ic, 0)
        diff = query64[lo:hi, None, :] - ref64[safe]      # (chunk, k_sel, d)
        d2 = np.einsum("nkd,nkd->nk", diff, diff)
        d2[ic < 0] = np.inf
        if self_mode:
            d2[ic == np.arange(lo, hi)[:, None]] = 0.0
        d2.sort(axis=1)
        out[lo:hi] = d2
    return np.sqrt(out)


def exact_knn(query: np.ndarray, ref: Optional[np.ndarray], k: int,
              *, refine: bool = True, pad_candidates: int = 4,
              engine: str = "auto", device="cuda") -> np.ndarray:
    """Sorted kNN distances.

    Args:
      query: (Nq, d) float64 whitened samples.
      ref:   (Nr, d) float64 whitened reference set, or None for self mode
             (auto-evidence: ref = query, self match included as column 0).
      k:     number of distance columns to return.
      refine: recompute the candidates' distances in f64 on the host (the
        parity pipeline); False returns the selection's f32 distances (the
        ``fast`` precision).
      pad_candidates: extra f32-selected candidates per row when refining;
        guards against f32 rounding flipping the selection boundary.
      engine: see the module docstring.
      device: where the selection runs; ``"cuda"`` raises without a card.

    Returns:
      (Nq, k) float64 sorted ascending distances.
    """
    self_mode = ref is None
    ref64 = query if self_mode else ref
    sel = selector(engine, width=query.shape[1], refine=refine)
    dev = resolve_device(device)
    nq, nr = query.shape[0], ref64.shape[0]
    k = min(k, nr)
    k_sel = min(nr, k + (pad_candidates if refine else 0))

    q_np, r_np = center_f64(query, None if self_mode else ref64)
    q32 = torch.as_tensor(q_np, dtype=torch.float32).to(dev)
    r32 = q32 if self_mode else torch.as_tensor(
        r_np, dtype=torch.float32).to(dev)

    if not refine:
        d2 = sel(q32, r32, k_sel, self_mode=self_mode)[0]
        return np.sqrt(d2.cpu().numpy().astype(np.float64))[:, :k]

    def select(ks):
        return sel(q32, r32, ks, self_mode=self_mode)[1].cpu().numpy()

    idx = select(k_sel)
    if k_sel < nr:
        return guarded_refine_knn_f64(q_np, r_np, idx, k,
                                      self_mode=self_mode, reselect=select)
    return _refine_knn_f64_all(q_np, r_np, idx, self_mode)[:, :k]
