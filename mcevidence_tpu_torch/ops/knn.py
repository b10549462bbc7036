"""Exact k-nearest-neighbour distances: f32 selection and f64 refine on the card.

The counterpart of ``mcevidence_tpu/ops/knn.py``:

* selection: the reference-set-centred f64 coordinates are uploaded, cast
  to f32 on ``device`` (the same IEEE rounding as a host cast) and k_sel =
  k + pad candidates per row are selected there.
* refinement (``refine=True``, the default): the candidates' distances are
  recomputed in f64 on ``device`` with the cancellation-free difference
  form and re-sorted (``refined_d2_chunks``, which the device precision
  shares), and a sufficiency guard re-selects once with 4*k_sel+8
  candidates when the k-th refined distance sits within 2^-10 of the
  candidate boundary (``thin_rows``).  Only the (Nq, k) distances and the
  thin count come back to the host, in one copy.
  ``guarded_refine_knn_f64`` is the same refine and guard in numpy on host
  indices, for the ring, whose candidates come from several ranks.
* ``refine=False`` (the ``fast`` precision): k candidates are selected by
  the exact dispatch and the square roots of their f32 d2 come back as f64.

Spans (``utils/spans.py``) on the refine path: ``host_prep`` (the f64
centring), ``upload`` (the f64 copies to the device and the f32 cast
there), ``select`` (each pass's launch and the wait for it), ``host_refine``
(each pass's f64 refine, margin test and fetch) and ``reselect`` (the
guard's second pass, around its own ``select`` and ``host_refine``).

Engines (``engine=``), each mapped onto the kernels the JAX package runs
on each path (``selector``):

* ``"auto"``, ``"cuda"`` (alias ``"pallas"``) and ``"pallas_exact"``: the
  exact k-dependent kernel dispatch, small-k kernel below 14 candidates and
  large-k kernel from there, the wide kernel past 256 candidates or 64
  columns (``pallas_exact`` is K4's forced engine in the JAX package; every
  kernel here is exact, so it takes the same dispatch).
  On a CPU device the kernel wrappers run their plain version.
* ``"pallas_smalld"``: the small-d kernel (K8/K9's counterpart) where the
  JAX package runs it, refine consumers with d <= 16; wider inputs take the
  exact dispatch, and so does ``refine=False``.
* ``"pallas_packed"``: K6's counterpart (``knn_select_packed``, 11 low
  bits), K7's (its batched form) on the batched device paths.
* ``"pallas_packed2"``: K1's counterpart as a forced engine
  (``knn_select_packed``, 12 low bits) at any k; the exact batched kernel
  (K5) on the batched device paths.
* ``"pallas_binned"``: the large-k kernel at any k (K2/K3's exact
  counterpart) on the host paths, K1's on the one-chain device path.
* ``"torch"`` (alias ``"xla"``): the plain PyTorch selection.

The packed engines' truncated d2 reach ``refine=False`` (the ``fast``
precision), as the JAX package's do.  The grid's fast program takes the
exact batched selection under every engine but ``torch``: the JAX package
passes it no engine.

Auto-evidence ("self mode", ``ref=None``) keeps the reference's semantics:
the query point itself is neighbour 0 at distance exactly 0.
"""

from __future__ import annotations

import functools
import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.spans import span
from .knn_hopper import (SMALLD_MAX, knn_select_batched, knn_select_cuda,
                         knn_select_large_k, knn_select_packed,
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


ENGINES = ("auto", "cuda", "pallas", "pallas_exact", "pallas_packed",
           "pallas_packed2", "pallas_binned", "pallas_smalld", "torch", "xla")
_KINDS = {"auto": "cuda", "cuda": "cuda", "pallas": "cuda",
          "pallas_exact": "cuda", "pallas_smalld": "smalld",
          "pallas_packed": "packed", "pallas_packed2": "packed2",
          "pallas_binned": "binned", "torch": "torch", "xla": "torch"}

ENGINE_HELP = ("kNN selection engine: 'auto', 'cuda' (alias 'pallas') and "
               "'pallas_exact' run the exact k-dependent CUDA kernel "
               "dispatch (the plain PyTorch selection on --device cpu); "
               "'pallas_smalld' the small-d kernel where candidates are "
               "refined (d <= 16); 'pallas_packed' (11 low bits) and "
               "'pallas_packed2' (12) the truncated-key kernels, whose d2 "
               "the fast precision consumes; 'pallas_binned' the large-k "
               "kernel at any k; 'torch' (alias 'xla') the plain PyTorch "
               "selection")

# The paths that select, with the JAX package's dispatch each follows:
#   refine     exact_knn, refine=True, and the refine guard's reselect
#              (mcevidence_tpu/ops/knn.py:316-356)
#   fast       exact_knn(refine=False) and the fused fast program
#              (knn.py:316-356, pipeline.py:55-67)
#   device     device precision, one chain (pipeline.py:332-357)
#   batched    device precision, a batch of chains, and the grid's refine
#              batches (pipeline.py:271-291, parallel/ring.py:1050-1071)
#   grid_fast  the grid's fast program (planck.py:468: no engine)
PATHS = ("refine", "fast", "device", "batched", "grid_fast")


def resolve_engine(engine: str) -> str:
    """Map an engine name onto its kind: ``"cuda"`` (the exact dispatch),
    ``"smalld"``, ``"packed"``, ``"packed2"``, ``"binned"`` or
    ``"torch"``; raises for unknown names."""
    if engine not in _KINDS:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    return _KINDS[engine]


def _packed(low_bits: int):
    return functools.partial(knn_select_packed, low_bits=low_bits)


def selector(engine: str, path: str, *, width: int):
    """The selection ``engine`` runs on ``path`` (one of ``PATHS``) for rows
    ``width`` coordinates wide; the batched paths get the (B, N, d) forms.
    Every callable takes (query, ref, k, *, self_mode, nr[, nq])."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    kind = resolve_engine(engine)
    batched = path in ("batched", "grid_fast")
    if kind == "torch":
        return knn_select_torch_batched if batched else knn_select_torch
    exact = knn_select_batched if batched else knn_select_cuda
    if path == "grid_fast":
        return exact
    if kind == "smalld":
        return (knn_select_smalld if path != "fast" and width <= SMALLD_MAX
                else exact)
    if kind == "packed":
        return _packed(11)
    if kind == "packed2":
        return exact if batched else _packed(12)
    if kind == "binned":
        return {"refine": knn_select_large_k, "fast": knn_select_large_k,
                "device": _packed(12)}.get(path, exact)
    return exact


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


def thin_rows(kth, boundary):
    """The candidate-sufficiency test, on numpy arrays or tensors of sorted
    refined distances: rows whose k-th distance ``kth`` sits within the
    f32/packed ranking noise (~2^-11 relative) of the worst kept candidate
    ``boundary``, which is finite and > 0."""
    return ((kth > boundary * (1.0 - 2.0 ** -10)) & (boundary > 0)
            & (boundary < math.inf))


def _guarded(d, n_thin, k_sel, n_ref, again):
    """The guard's policy on a first pass's distances ``d`` with ``n_thin``
    thin rows out of ``k_sel`` candidates: re-select once through
    ``again(k_sel')`` -> (d, n_thin) with k_sel' = 4*k_sel+8 (at most
    ``n_ref``), then warn if rows stay thin (near-exact ties leave the
    evidence unchanged to O(tie gap)).  ``again`` None: warn only."""
    if n_thin and again is not None:
        k_sel = min(4 * k_sel + 8, n_ref)
        logger.info("kNN candidate margin thin for %d/%d rows; re-selecting "
                    "with %d candidates", n_thin, len(d), k_sel)
        with span("reselect"):
            d, n_thin = again(k_sel)
    if n_thin:
        logger.warning(
            "kNN candidate margin thin for %d/%d rows (near-tied "
            "neighbour distances); parity may be limited by genuine "
            "ties, which leave the evidence unchanged to O(tie gap)",
            n_thin, len(d))
    return d


def guarded_refine_knn_f64(query64, ref64, idx, k, *, self_mode,
                           reselect=None) -> np.ndarray:
    """f64 candidate refinement + the candidate-sufficiency guard, on the
    host (numpy) for host indices.

    Refines all candidates in ``idx`` and checks that the k-th refined
    distance sits inside the candidate boundary (``thin_rows``); on a thin
    margin, calls ``reselect(k_sel)`` once for a larger candidate set,
    then warns (``_guarded``).
    """
    def refine(ic):
        with span("host_refine"):
            d_all = _refine_knn_f64_all(query64, ref64, ic, self_mode)
            n_thin = 0
            if d_all.shape[1] > k:
                n_thin = int(np.count_nonzero(
                    thin_rows(d_all[:, k - 1], d_all[:, -1])))
        return d_all[:, :k], n_thin
    again = None if reselect is None else (lambda ks: refine(reselect(ks)))
    return _guarded(*refine(idx), np.shape(idx)[1], ref64.shape[0], again)


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


# peak memory one refinement chunk may use for its (rows, k_sel, d) f64
# workspace; chunking over query rows keeps the refine flat in memory
_REFINE_CHUNK_BYTES = int(float(os.environ.get(
    "MCE_REFINE_CHUNK_MB", "256")) * 2 ** 20)


def refine_chunk_rows(k_sel: int, d: int) -> int:
    """Query rows per refinement chunk: ``_REFINE_CHUNK_BYTES`` over the
    diff, its square and the d2 sum, ~3 live f64 (rows, k_sel, d)
    buffers."""
    return max(1, _REFINE_CHUNK_BYTES // max(3 * k_sel * d * 8, 1))


def refined_d2_chunks(q64, r64, idx, *, self_mode: bool, offset: int = 0):
    """The candidates' squared distances in f64 on the tensors' device.

    ``q64`` (Nq, d) and ``r64`` (Nr, d) f64 tensors, ``idx`` (Nq, k_sel)
    candidate rows of ``r64`` (-1: absent, distance inf).  In self mode
    query row i is reference row ``offset`` + i, whose own candidate is set
    to distance 0.  Yields (lo, hi, d2) for the query rows lo..hi, in
    chunks of ``refine_chunk_rows``, d2 (hi - lo, k_sel) sorted ascending
    along each row."""
    nq, k_sel = idx.shape
    dev = q64.device
    rows = refine_chunk_rows(k_sel, q64.shape[1])
    for lo in range(0, nq, rows):
        hi = min(nq, lo + rows)
        ic = idx[lo:hi].long()
        diff = q64[lo:hi, None, :] - r64[ic.clamp(min=0)]
        d2 = (diff * diff).sum(-1).masked_fill(ic < 0, math.inf)
        if self_mode:
            own = torch.arange(offset + lo, offset + hi, device=dev)[:, None]
            d2 = d2.masked_fill(ic == own, 0.0)
        yield lo, hi, torch.sort(d2, dim=1).values


def refine_knn_on_device(q64, r64, idx, k: int, *, self_mode: bool):
    """One refine pass on the tensors' device: the sorted f64 distances of
    every candidate in ``idx`` (``refined_d2_chunks``), their k smallest and
    the number of ``thin_rows`` (counted when ``idx`` holds more than k
    candidates), fetched in ONE copy.  Returns (the (Nq, k) f64 numpy
    distances, the thin count)."""
    nq, k_sel = idx.shape
    # the distances, then the count (exact in f64 below 2^53)
    buf = q64.new_zeros(nq * k + 1)
    out = buf[:-1].view(nq, k)
    for lo, hi, d2 in refined_d2_chunks(q64, r64, idx, self_mode=self_mode):
        d = d2.sqrt()
        out[lo:hi] = d[:, :k]
        if k_sel > k:
            buf[-1] += thin_rows(d[:, k - 1], d[:, -1]).sum()
    host = buf.cpu().numpy()
    return host[:-1].reshape(nq, k), int(host[-1])


def _refine_knn_f64_all(query64, ref64, idx, self_mode) -> np.ndarray:
    """All candidate distances, refined in f64 on the host and sorted
    ascending.

    Streams over query rows in ``refine_chunk_rows`` chunks: the (rows,
    k_sel, d) difference workspace is the host refine's only
    N-proportional allocation."""
    idx = np.asarray(idx)
    nq, k_sel = idx.shape
    rows_per_chunk = refine_chunk_rows(k_sel, query64.shape[1])
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
      refine: recompute the candidates' distances in f64 on ``device`` (the
        parity pipeline); False returns the selection's f32 distances (the
        ``fast`` precision; truncated under the packed engines).
      pad_candidates: extra f32-selected candidates per row when refining;
        guards against f32 rounding flipping the selection boundary.
      engine: see the module docstring.
      device: where the selection and the refine run; ``"cuda"`` raises
        without a card.

    Returns:
      (Nq, k) float64 sorted ascending distances.
    """
    self_mode = ref is None
    ref64 = query if self_mode else ref
    sel = selector(engine, "refine" if refine else "fast",
                   width=query.shape[1])
    dev = resolve_device(device)
    nq, nr = query.shape[0], ref64.shape[0]
    k = min(k, nr)
    k_sel = min(nr, k + (pad_candidates if refine else 0))

    with span("host_prep"):
        q_np, r_np = center_f64(query, None if self_mode else ref64)
    with span("upload"):
        q64 = torch.as_tensor(q_np, device=dev)
        r64 = q64 if self_mode else torch.as_tensor(r_np, device=dev)
        q32 = q64.to(torch.float32)
        r32 = q32 if self_mode else r64.to(torch.float32)

    if not refine:
        d2 = sel(q32, r32, k_sel, self_mode=self_mode)[0]
        return np.sqrt(d2.cpu().numpy().astype(np.float64))[:, :k]

    def refine_pass(ks):
        with span("select"):
            idx = sel(q32, r32, ks, self_mode=self_mode)[1]
            if idx.is_cuda:
                torch.cuda.current_stream(idx.device).synchronize()
        with span("host_refine"):
            return refine_knn_on_device(q64, r64, idx, k,
                                        self_mode=self_mode)

    d, n_thin = refine_pass(k_sel)
    if k_sel == nr:
        return d
    return _guarded(d, n_thin, k_sel, nr, refine_pass)
