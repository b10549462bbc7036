"""Carry the JAX package's state into the port's own objects.

The system has no learned weights; its state is the ingested chain
(``ChainPair`` of ``Partition``s) and the whitening (``WhitenStats``), both
plain numpy.  These functions read the reference objects by attribute,
without importing ``mcevidence_tpu`` (which would load jax), and build the
port's equivalents, so that both packages can compute from identical state.
"""

from __future__ import annotations

import numpy as np

from .chains.records import ChainPair, Partition
from .ops.whiten import WhitenStats


def _copy(a):
    return None if a is None else np.array(a, dtype=np.float64, copy=True)


def partition_from_reference(part) -> Partition:
    return Partition(samples=_copy(part.samples),
                     loglikes=_copy(part.loglikes),
                     weights=_copy(part.weights),
                     adjusted_weights=_copy(part.adjusted_weights))


def chain_pair_from_reference(pair) -> ChainPair:
    """A port ``ChainPair`` holding copies of ``pair``'s arrays."""
    offsets = pair.chain_offsets
    return ChainPair(
        s1=partition_from_reference(pair.s1),
        s2=None if pair.s2 is None else partition_from_reference(pair.s2),
        nchains=int(pair.nchains),
        chain_offsets=None if offsets is None else np.array(offsets))


def whiten_stats_from_reference(stats) -> WhitenStats:
    """A port ``WhitenStats`` holding copies of ``stats``'s arrays."""
    return WhitenStats(cov=_copy(stats.cov), eigvals=_copy(stats.eigvals),
                       eigvecs=_copy(stats.eigvecs),
                       log_jacobian=float(stats.log_jacobian),
                       posdef=bool(stats.posdef))
