"""Immutable chain containers.

The reference mutates a ``data_set`` record in place through a mixin
(reference MCEvidence.py:99-104, 107-532).  Here a chain partition is an
immutable value object; every preprocessing step returns a new object.
Host-side arrays are float64 numpy — file parsing and O(N) bookkeeping stay on
CPU; only the O(N^2 d) compute moves to device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """One chain partition: samples + per-row metadata.

    Mirrors the reference's ``data_set`` fields (MCEvidence.py:99-104):
    ``samples`` (N, d), ``weights`` (N,), ``loglikes`` (N,) storing -lnL in
    CosmoMC convention, and ``adjusted_weights`` (N,) — a copy of weights that
    importance reweighting may rescale independently (MCEvidence.py:244-247).
    """

    samples: np.ndarray            # (N, d) float64
    loglikes: np.ndarray           # (N,)  float64, stores -lnL (CosmoMC sign)
    weights: np.ndarray            # (N,)  float64
    adjusted_weights: np.ndarray   # (N,)  float64

    def __post_init__(self):
        n = self.samples.shape[0]
        for name in ("loglikes", "weights", "adjusted_weights"):
            a = getattr(self, name)
            if a.shape != (n,):
                raise ValueError(f"{name} has shape {a.shape}, expected ({n},)")

    @property
    def nsamples(self) -> int:
        return int(self.samples.shape[0])

    @property
    def ndim(self) -> int:
        return int(self.samples.shape[1])

    @property
    def shape(self) -> tuple:
        return self.samples.shape

    def lnp(self) -> np.ndarray:
        """+lnL array (reference ``arrays()`` returns -loglikes, MCEvidence.py:394-401)."""
        return -self.loglikes

    @staticmethod
    def empty(ndim: int = 0) -> "Partition":
        z = np.zeros((0,), dtype=np.float64)
        return Partition(np.zeros((0, ndim), dtype=np.float64), z, z, z)

    @staticmethod
    def from_columns(raw: np.ndarray, iw: int = 0, ilike: int = 1,
                     itheta: int = 2) -> "Partition":
        """Build from a raw CosmoMC column matrix ``[weight, -lnL, theta...]``
        (column convention: reference MCEvidence.py:126-128, 232-240)."""
        raw = np.asarray(raw, dtype=np.float64)
        if raw.ndim != 2 or raw.shape[1] < itheta + 1:
            raise ValueError(f"raw chain must be 2-D with >= {itheta + 1} columns, "
                             f"got shape {raw.shape}")
        w = raw[:, iw].copy()
        return Partition(samples=raw[:, itheta:].copy(),
                         loglikes=raw[:, ilike].copy(),
                         weights=w, adjusted_weights=w.copy())

    def with_adjusted_weights(self, aw: np.ndarray) -> "Partition":
        return dataclasses.replace(self, adjusted_weights=np.asarray(aw, dtype=np.float64))

    def take(self, idx) -> "Partition":
        """Row subset (burn-in, thinning, split all reduce to this)."""
        return Partition(self.samples[idx], self.loglikes[idx],
                         self.weights[idx], self.adjusted_weights[idx])

    def with_weights(self, w: np.ndarray) -> "Partition":
        """Replace weights AND reset adjusted_weights to a copy — matches the
        reference's thinning behaviour (MCEvidence.py:334-337)."""
        w = np.asarray(w, dtype=np.float64)
        return dataclasses.replace(self, weights=w, adjusted_weights=w.copy())


@dataclasses.dataclass(frozen=True)
class ChainPair:
    """The (s1, s2) partition pair the estimator consumes.

    Auto-evidence: s2 is None (reference ``chain_split`` no-split branch,
    MCEvidence.py:237-242).  Cross-evidence: s2 holds the complement rows.
    """

    s1: Partition
    s2: Optional[Partition] = None
    nchains: int = 1
    # bookkeeping parity with the reference (chain_offsets / ichain labels,
    # MCEvidence.py:197,205): row-count offsets of the concatenated chains.
    chain_offsets: Optional[np.ndarray] = None

    @property
    def split(self) -> bool:
        return self.s2 is not None

    def get_shape(self, name: str = "s1") -> tuple:
        """Per-partition or combined shape (reference MCEvidence.py:252-263)."""
        if name == "s1":
            return self.s1.shape
        if name == "s2":
            return self.s2.shape if self.s2 is not None else (0, 0)
        n2 = self.s2.nsamples if self.s2 is not None else 0
        return (self.s1.nsamples + n2, self.s1.ndim)

    def partition(self, name: str) -> Partition:
        if name == "s1":
            return self.s1
        if name == "s2":
            if self.s2 is None:
                raise ValueError("no s2 partition: chain was not split")
            return self.s2
        raise ValueError(f"unknown partition {name!r}")

    def all_samples(self) -> np.ndarray:
        """Concatenated s1+s2 samples (reference all_sample_arrays, MCEvidence.py:407-415)."""
        if self.s2 is None:
            return self.s1.samples
        return np.concatenate([self.s1.samples, self.s2.samples], axis=0)
