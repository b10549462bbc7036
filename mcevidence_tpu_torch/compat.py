"""Reference-compatible ``MCSamples`` surface.

The counterpart of ``mcevidence_tpu/compat.py``, on the host only.  The
reference exposes a chain-container class with mutable partitions and
mixin methods (``MCSamples``/``SamplesMIXIN``, reference MCEvidence.py:
107-606).  The package's core is immutable/functional (chains/records.py,
chains/preprocess.py); this module wraps it in the reference's mutable
method surface so existing MCEvidence user code keeps working:

    gd = MCSamples(root_or_dict, csplit=split_var(...), burnlen=.., thinlen=..)
    s, lnp, w = gd.arrays('s1')
    gd.get_shape('s1'); gd.all_sample_arrays()
    gd.importance_sample(func, name='s1')
    gd.removeBurn(0.2, name='s1'); gd.thin(2, name='s1')

``split_var`` mirrors the reference's csplit namedtuple
(MCEvidence.py:750-751); its ``shuffle`` field is accepted for parity but —
like the reference (quirk Q8) — has no effect.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Optional

import numpy as np

from .chains.preprocess import (burn_length, get_thin_index,
                                importance_sample as _importance)
from .chains.reader import ingest
from .chains.records import ChainPair, Partition

split_var = namedtuple("split_var", "split frac shuffle")


class MCSamples:
    """Chain container with the reference's method surface."""

    def __init__(self, str_or_dict, trueval=None, debug: bool = False,
                 csplit: Optional[split_var] = None, names=None, labels=None,
                 px: str = "x", seed: Optional[int] = None, **kwargs):
        self.debug = debug
        self.trueval = trueval
        self.px = px
        if csplit is None:
            self.split, self.s1frac, self.shuffle = False, 0.5, True
        else:
            self.split = csplit.split
            self.s1frac = csplit.frac
            self.shuffle = csplit.shuffle

        burnlen = kwargs.pop("burnlen", 0.0)
        thinlen = kwargs.pop("thinlen", 0.0)
        idchain = kwargs.pop("idchain", 0)
        idpattern = kwargs.pop("idpattern", "_?.txt")
        kwargs.pop("log_level", None)
        self.rng = np.random.default_rng(seed)
        self.pair: ChainPair = ingest(
            str_or_dict, burnlen=burnlen, thinlen=thinlen, split=self.split,
            s1frac=self.s1frac, idchain=idchain, idpattern=idpattern,
            rng=self.rng)
        ndim = self.get_shape()[1]
        self.names = names or [f"p{i}" for i in range(ndim)]
        self.labels = labels or [f"{px}_{i}" for i in range(ndim)]
        self.nparamMC = ndim

    # -- the reference's data attribute: dict of per-partition records ----
    @property
    def data(self):
        d = {"s1": self.pair.s1}
        if self.pair.s2 is not None:
            d["s2"] = self.pair.s2
        return d

    # -- shapes / arrays (reference MCEvidence.py:252-263, 394-415) -------
    def get_shape(self, name: str = "s1"):
        return self.pair.get_shape(name)

    def arrays(self, name: str = "s1"):
        if name in ("s1", "s2"):
            if name == "s2" and self.pair.s2 is None:
                return None, None, None
            p = self.pair.partition(name)
            return p.samples, p.lnp(), p.weights
        return self.all_sample_arrays()

    def all_sample_arrays(self):
        s1 = self.pair.s1
        if self.pair.s2 is None:
            return s1.samples, s1.lnp(), s1.weights
        s2 = self.pair.s2
        return (np.concatenate([s1.samples, s2.samples]),
                np.concatenate([s1.lnp(), s2.lnp()]),
                np.concatenate([s1.weights, s2.weights]))

    # -- importance reweighting (reference MCEvidence.py:265-270) ---------
    def importance_sample(self, func, name: str = "s1"):
        self.pair = _importance(self.pair, func, names=(name,))

    # -- burn-in on a partition (reference MCEvidence.py:350-391) ---------
    def removeBurn(self, remove, chain=None, name=None):
        # Parity: with neither `chain` nor `name`, the reference returns
        # `remove` unchanged (MCEvidence.py:357-359) — NOT a default-s1 burn.
        if chain is not None:
            nstart = burn_length(remove, chain.shape[0])
            return chain[nstart:, :]
        if name is None:
            return remove
        p = self.pair.partition(name)
        nstart = burn_length(remove, p.nsamples)
        if nstart > p.nsamples:
            raise ValueError(f"burn-in failed: {nstart} > {p.nsamples}")
        self._replace(name, p.take(np.arange(nstart, p.nsamples)))

    # -- thinning on a partition (reference MCEvidence.py:289-348) --------
    def thin(self, nthin=1, name: str = "s1", chain=None):
        # Parity: nthin==1 returns None even in raw-chain mode
        # (MCEvidence.py:296-297, quirk Q9); the fixed behaviour lives in
        # chains.preprocess.thin_chain, which returns the chain unchanged.
        if nthin == 1:
            return None
        if chain is not None:
            from .chains.preprocess import thin_chain
            return thin_chain(np.asarray(chain), nthin, rng=self.rng)
        p = self.pair.partition(name)
        new_w, ix = get_thin_index(nthin, p.weights, rng=self.rng)
        self._replace(name, p.take(ix).with_weights(new_w))
        return self.pair.partition(name)

    def _replace(self, name: str, part: Partition):
        if name == "s1":
            self.pair = dataclasses.replace(self.pair, s1=part)
        else:
            self.pair = dataclasses.replace(self.pair, s2=part)
