"""Batching semantics (nbatch / brange / bscale).

Replicates the reference's batch bookkeeping (MCEvidence.py:797-840):
* brange None      — one batch covering each whole partition.
* bscale 'logpower'— batch sizes 10^linspace(powmin, powmax, nbatch).
* bscale 'linear'  — batch sizes linspace(powmin, powmax, nbatch)
  (the reference NameErrors on this branch — quirk Q4; implemented properly).
* otherwise       — 'constant': bsize = brange, batch sample counts are the
  cumulative sums of bsize (growing prefixes).

Batches are prefixes of the chain (the reference's ``istart=itot`` is never
advanced, so every batch starts at row 0) or uniform-random row subsets when
``rand=True`` (reference MCEvidence.py:884-899,1041-1048).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    nbatch: int
    powers: np.ndarray   # (nbatch, npartitions) log10 of batch sizes
    bsize: Optional[np.ndarray]   # (nbatch, npartitions) or None (brange=None)
    nchain: np.ndarray   # (nbatch, npartitions) samples analysed per batch

    def batch_sizes_s1(self) -> np.ndarray:
        """S per batch (reference uses nchain column 0: MCEvidence.py:1041-1042)."""
        return self.nchain[:, 0].astype(int)


def get_batch_range(brange) -> tuple:
    bmin = float(np.min(np.asarray(brange)))
    bmax = float(np.max(np.asarray(brange)))
    return bmin, bmax


def make_batch_plan(nsamples: Sequence[int], nbatch: int = 1,
                    brange: Optional[Union[int, Sequence]] = None,
                    bscale: str = "") -> BatchPlan:
    npart = len(nsamples)
    if isinstance(brange, int):
        bscale = "constant"   # reference MCEvidence.py:680

    if brange is None:
        # one batch covering the whole chain, regardless of nbatch: the
        # trailing rows would carry S=0, which _get_batch reads as "full
        # partition" — nbatch-1 redundant full O(N^2) passes whose results
        # are discarded (round-4 review)
        if nbatch > 1:
            logging.getLogger(__name__).warning(
                "nbatch=%d ignored: batching requires brange "
                "(reference semantics — brange=None means one batch)",
                nbatch)
        nbatch = 1
        powers = np.zeros((nbatch, npart))
        nchain = np.zeros((nbatch, npart), dtype=int)
        for ix, nn in enumerate(nsamples):
            nchain[0, ix] = nn
            powers[0, ix] = np.log10(max(nn, 1))
        return BatchPlan(nbatch=nbatch, powers=powers, bsize=None, nchain=nchain)

    powers = np.zeros((nbatch, npart))
    bsize = np.zeros((nbatch, npart), dtype=int)
    if bscale in ("logpower", "linear"):
        # the zero-range guard lives in the ranged branches only: 'constant'
        # never consults the range (reference MCEvidence.py:797-840)
        powmin, powmax = get_batch_range(brange)
        if powmin == powmax and nbatch > 1:
            raise ValueError("nbatch>1 but batch range is zero")
    if bscale == "logpower":
        for ix in range(npart):
            powers[:, ix] = np.linspace(powmin, powmax, nbatch)
            bsize[:, ix] = np.power(10.0, powers[:, ix]).astype(int)
    elif bscale == "linear":
        for ix in range(npart):
            bsize[:, ix] = np.linspace(powmin, powmax, nbatch).astype(int)
            powers[:, ix] = np.log10(np.maximum(bsize[:, ix], 1))
    else:  # constant
        arr = np.asarray(brange, dtype=int)
        if arr.ndim > 0 and arr.size not in (1, npart):
            raise ValueError(
                f"bscale='constant' (the default when brange is a sequence) "
                f"expects a scalar batch size or one per partition "
                f"({npart}); got {arr.size} values.  For a (min, max) batch "
                f"range pass bscale='logpower' or 'linear'.")
        bsize[:, :] = arr
        powers[:, :] = np.arange(nbatch, dtype=float)[:, None]
        nchain = np.zeros((nbatch, npart), dtype=int)
        for ix in range(npart):
            nchain[:, ix] = np.cumsum(bsize[:, ix])
        return BatchPlan(nbatch=nbatch, powers=powers, bsize=bsize,
                         nchain=nchain)
    # ranged branches: a plan entry of 0 would read downstream as "use the
    # full partition" (_get_batch's nsamples<=0 sentinel), silently labelling
    # a full-chain ln Z as the smallest point of the convergence curve —
    # clamp to 1 so a degenerate request fails loudly in the estimator
    # instead (the displayed powers already assumed the clamp)
    if np.any(bsize < 1):
        logging.getLogger(__name__).warning(
            "batch plan clamped %d zero-size batches to 1 sample "
            "(brange=%s, bscale=%r)", int(np.sum(bsize < 1)), brange, bscale)
        bsize = np.maximum(bsize, 1)
    nchain = bsize.copy()
    return BatchPlan(nbatch=nbatch, powers=powers, bsize=bsize, nchain=nchain)
