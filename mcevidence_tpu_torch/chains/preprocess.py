"""Host-side chain preprocessing: burn-in, thinning, splitting, reweighting.

These are cheap, data-dependent O(N) operations, so they stay on CPU/numpy
(device work starts at whitening/kNN).  Semantics replicate the reference:

* burn-in          — reference MCEvidence.py:350-391
* Poisson thinning — reference MCEvidence.py:417-445
* weighted binning — reference MCEvidence.py:447-479
* integer thinning — reference MCEvidence.py:481-532 (getdist algorithm)
* dispatch         — reference MCEvidence.py:272-287
* chain split      — reference MCEvidence.py:221-249
* importance       — reference MCEvidence.py:265-270

All randomized steps take an explicit ``numpy.random.Generator`` instead of
the reference's global RNG (quirk Q8 in SURVEY.md).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import numpy as np

from .records import ChainPair, Partition

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# burn-in
# --------------------------------------------------------------------------

def burn_length(remove: float, nrows: int) -> int:
    """Rows to drop: fraction of ``nrows`` if remove<1, else absolute count
    (reference MCEvidence.py:362-371)."""
    if remove < 1:
        return int(nrows * remove)
    return int(remove)


def remove_burn(chain: np.ndarray, remove: float) -> np.ndarray:
    """Drop the first ``burn_length`` rows of a raw chain matrix."""
    nstart = burn_length(remove, chain.shape[0])
    if nstart > chain.shape[0]:
        raise ValueError(
            f"burn-in failed: burn length {nstart} > sample length {chain.shape[0]}")
    return chain[nstart:, :]


# --------------------------------------------------------------------------
# thinning
# --------------------------------------------------------------------------

def poisson_thin(frac: float, weights: np.ndarray,
                 rng: Optional[np.random.Generator] = None):
    """Poisson thinning: new weight ~ Poisson(w * frac); keep rows with new
    weight > 0 (reference MCEvidence.py:417-445).

    Returns (thin_ix, new_weights).
    """
    if rng is None:
        rng = np.random.default_rng()
    lam = np.asarray(weights, dtype=np.float64) * frac
    new_w = rng.poisson(lam).astype(np.float64)
    thin_ix = np.nonzero(new_w > 0)[0]
    return thin_ix, new_w[thin_ix]


def weighted_thin(thin_unit: float, weights: np.ndarray):
    """Weighted-binning thinning: bin the row index range into N2 bins and
    keep the (first) argmax-weight row of each bin (reference
    MCEvidence.py:447-479).

    ``thin_unit`` >= 1 gives N2 = N // thin_unit bins; 0 < thin_unit < 1 gives
    N2 = int(N * thin_unit).  Returns (thin_ix, new_weights).
    """
    weights = np.asarray(weights, dtype=np.float64)
    n = len(weights)
    if thin_unit == 0:
        return np.arange(n), weights
    n2 = int(n * thin_unit) if thin_unit < 1 else int(n // thin_unit)
    if n2 <= 0:
        raise ValueError(f"thin_unit={thin_unit} leaves no bins for n={n}")
    # Bin edges over the index range; bin id per row (same construction as the
    # reference's digitize over linspace(-1, N, N2+1)).
    bins = np.linspace(-1, n, n2 + 1)
    ind = np.digitize(np.arange(n), bins)
    # First-occurrence argmax of weights within each bin, vectorized:
    # sort by (bin, -weight, index); the first row of each bin group wins.
    order = np.lexsort((np.arange(n), -weights, ind))
    sorted_bins = ind[order]
    first_of_group = np.ones(n, dtype=bool)
    first_of_group[1:] = sorted_bins[1:] != sorted_bins[:-1]
    thin_ix = np.sort(order[first_of_group])
    return thin_ix, weights[thin_ix]


def thin_indices(factor: float, weights: np.ndarray):
    """Integer-weight thinning (getdist ``WeightedSamples.thin`` semantics;
    reference MCEvidence.py:481-532).

    Treat each row as ``weight`` unit samples; keep the row containing every
    ``factor``-th unit sample.  Requires integer weights and integer factor.
    Returns (thin_ix, weights[thin_ix]).
    """
    weights = np.asarray(weights)
    norm1 = np.sum(weights)
    int_weights = weights.astype(np.int64)
    norm = int(np.sum(int_weights))
    if abs(norm - norm1) > 1e-4:
        raise ValueError("Can only thin with integer weights")
    if factor != int(factor):
        raise ValueError("Thin factor must be integer")
    factor = int(factor)

    if factor >= int_weights.max():
        # Coarse regime: group rows by cumsum // factor, keep the first row of
        # each group (reference's np.unique(return_index=True) branch).
        cumsum = np.cumsum(int_weights) // factor
        _, thin_ix = np.unique(cumsum, return_index=True)
    else:
        # Fine regime: unit sample t lives in the row i with
        # cumsum[i-1] < t <= cumsum[i]; emit the row of every t = m*factor.
        # (Vectorized restatement of getdist's sequential walk.)
        cumsum = np.cumsum(int_weights)
        targets = np.arange(factor, norm - (norm % factor) + 1, factor)
        thin_ix = np.searchsorted(cumsum, targets, side="left")
    return thin_ix, int_weights[thin_ix]


def get_thin_index(nthin: float, weights: np.ndarray,
                   rng: Optional[np.random.Generator] = None):
    """Thinning dispatch (reference MCEvidence.py:272-287): |nthin|<1 picks
    Poisson thinning; otherwise the getdist integer algorithm with a fallback
    to weighted binning when weights are non-integer.

    Returns (new_weights, thin_ix) — note the reference's argument order.
    """
    if nthin < 1:
        thin_ix, new_w = poisson_thin(nthin, weights, rng=rng)
    else:
        try:
            thin_ix, new_w = thin_indices(nthin, weights)
        except (ValueError, OverflowError):
            thin_ix, new_w = weighted_thin(nthin, weights)
    return new_w, thin_ix


def autocorr_time(x: np.ndarray, c: float = 5.0) -> float:
    """Integrated autocorrelation time of a 1-D sequence (Sokal window).

    FFT autocorrelation, tau(M) = 1 + 2 sum_{t<=M} rho_t, with the window M
    chosen as the smallest M >= c * tau(M) (the emcee/Goodman-Weare
    convention).  Returns >= 1.0.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < 4:
        return 1.0
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acf = np.fft.irfft(f * np.conjugate(f), nfft)[:n]
    if acf[0] <= 0:
        return 1.0
    rho = acf / acf[0]
    taus = 1.0 + 2.0 * np.cumsum(rho[1:])
    windows = np.arange(1, len(taus) + 1)
    ok = windows >= c * taus
    m = int(np.argmax(ok)) if ok.any() else len(taus) - 1
    return float(max(taus[m], 1.0))


def autocorr_thin_factor(samples: np.ndarray, scale: float = 1.0) -> int:
    """Integer thinning factor from the worst per-parameter autocorrelation
    time of a chain's parameter block, scaled by ``scale``.

    Implements the reference CLI's documented-but-missing ``thinlen < 0``
    mode (quirk Q9; reference MCEvidence.py:1388-1392): |thinlen| scales the
    measured autocorrelation length.
    """
    taus = [autocorr_time(samples[:, j]) for j in range(samples.shape[1])]
    return max(1, int(round(max(taus) * scale)))


def thin_chain(chain: np.ndarray, nthin: float, iw: int = 0,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Thin a raw chain matrix; thinned rows get their new weights written into
    the weight column (reference MCEvidence.py:289-348, chain branch)."""
    if nthin == 1:
        return chain
    new_w, thin_ix = get_thin_index(nthin, chain[:, iw], rng=rng)
    out = chain[thin_ix, :].copy()
    out[:, iw] = new_w
    logger.debug("thinned chain: nthin=%s old=%d new=%d", nthin,
                 chain.shape[0], out.shape[0])
    return out


# --------------------------------------------------------------------------
# concatenation + split
# --------------------------------------------------------------------------

def split_rows(n: int, s1frac: float,
               rng: Optional[np.random.Generator] = None,
               ix: Optional[np.ndarray] = None):
    """Random partition of ``range(n)`` into (s1 rows, s2 rows).

    ``ix`` may be injected for deterministic tests (SURVEY.md §7 "RNG
    parity").  s1 keeps the sampled (unsorted) order; s2 is the sorted
    complement — matching the reference's choice/setxor1d construction
    (MCEvidence.py:224-226).
    """
    if ix is None:
        if rng is None:
            rng = np.random.default_rng()
        ix = rng.choice(n, size=int(n * s1frac), replace=False)
    not_ix = np.setdiff1d(np.arange(n), ix)
    return ix, not_ix


def build_chain_pair(chains: Sequence[np.ndarray],
                     burnlen: float = 0.0,
                     thinlen: float = 0.0,
                     split: bool = False,
                     s1frac: float = 0.5,
                     rng: Optional[np.random.Generator] = None,
                     split_ix: Optional[np.ndarray] = None,
                     iw: int = 0, ilike: int = 1, itheta: int = 2) -> ChainPair:
    """Per-chain burn-in -> concatenate -> thin -> optional split.

    The reference pipeline (``chains2samples``, MCEvidence.py:174-219) with
    explicit RNG.  ``chains`` are raw column matrices [weight, -lnL, theta...].
    """
    if not chains:
        raise ValueError("no chains given")
    chains = [np.atleast_2d(np.asarray(c, dtype=np.float64)) for c in chains]
    if burnlen > 0:
        chains = [remove_burn(c, burnlen) for c in chains]
    chain_offsets = np.cumsum([0] + [c.shape[0] for c in chains])
    samples = np.concatenate(chains, axis=0)
    if thinlen < 0:
        # thinlen < 0: thin by the chain's own autocorrelation length scaled
        # by |thinlen| — the mode the reference CLI documents but never
        # implemented (quirk Q9; it silently used |thinlen| instead).
        # tau is measured per chain and the worst one taken: concatenation
        # joins independent chains end-to-end, and a between-chain mean shift
        # masquerades as long-range autocorrelation in the joint ACF (or,
        # with opposed trends, cancels real autocorrelation).
        factor = max(autocorr_thin_factor(c[:, itheta:], scale=-thinlen)
                     for c in chains)
        logger.info("autocorrelation thinning: factor=%d", factor)
        if factor > 1:
            samples = thin_chain(samples, factor, iw=iw, rng=rng)
    elif thinlen > 0:
        samples = thin_chain(samples, thinlen, iw=iw, rng=rng)

    if split:
        ix, not_ix = split_rows(samples.shape[0], s1frac, rng=rng, ix=split_ix)
        s1 = Partition.from_columns(samples[ix], iw, ilike, itheta)
        s2 = Partition.from_columns(samples[not_ix], iw, ilike, itheta)
        logger.info("split chain nrow=%d -> ns1=%d ns2=%d",
                    samples.shape[0], len(ix), len(not_ix))
        return ChainPair(s1=s1, s2=s2, nchains=len(chains),
                         chain_offsets=chain_offsets)
    s1 = Partition.from_columns(samples, iw, ilike, itheta)
    return ChainPair(s1=s1, s2=None, nchains=len(chains),
                     chain_offsets=chain_offsets)


# --------------------------------------------------------------------------
# importance reweighting
# --------------------------------------------------------------------------

def importance_sample(pair: ChainPair, func: Callable[[np.ndarray], np.ndarray],
                      names: Sequence[str] = ("s1",),
                      strict: bool = False) -> ChainPair:
    """Multiply adjusted weights by exp(-negLogLikes) where negLogLikes =
    func(samples) (reference MCEvidence.py:265-270).

    Reference quirk Q7 (SURVEY.md §8): only ``adjusted_weights`` is rescaled,
    which enters the estimator solely through SumW; per-point weights inside
    the density sum stay unadjusted.  ``strict=False`` keeps that behaviour;
    ``strict=True`` additionally rescales ``weights`` (the arguably intended
    semantics) — off by default for golden-table parity.
    """
    parts = {"s1": pair.s1, "s2": pair.s2}
    for name in names:
        p = parts.get(name)
        if p is None:
            continue
        neg_lnl = np.asarray(func(p.samples), dtype=np.float64)
        factor = np.exp(-neg_lnl)
        p = p.with_adjusted_weights(p.adjusted_weights * factor)
        if strict:
            import dataclasses
            p = dataclasses.replace(p, weights=p.weights * factor)
        parts[name] = p
    return ChainPair(s1=parts["s1"], s2=parts["s2"], nchains=pair.nchains,
                     chain_offsets=pair.chain_offsets)
