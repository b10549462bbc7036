"""Chain ingestion: CosmoMC text chains and in-memory arrays.

File-name resolution mirrors the reference's loader (MCEvidence.py:567-606):
an existing file, a list of files, a wildcard pattern, ``root_<id>.txt`` via
``idchain``, or the default glob ``root`` + ``_?.txt`` (``idpattern``).
Column order is CosmoMC's ``weight  -lnL  param1  param2 ...``
(MCEvidence.py:569-570).

In-memory ingestion accepts:
* dict with explicit ``samples`` / ``loglikes`` / optional ``weights`` keys —
  the *intended* contract of the reference's dict path (its actual
  ``dict.values()`` concatenation is broken for the shapes every caller
  passes; SURVEY.md §3.3 / quirk Q6).  ``loglikes`` are +lnL in this path
  (examples.py:526-529 pass emcee/pystan log-probabilities), stored
  internally as -lnL; absent weights default to 1.
* list/tuple of raw column matrices (one per chain, CosmoMC column order).

Parsing is the hot host path for the Planck grid (tens of MB of text per
model); ``parse_chain_file`` uses the native C++ parser when built (see
``mcevidence_tpu_torch/native``), falling back to pandas/numpy.
"""

from __future__ import annotations

import glob as _glob
import logging
import os
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np

from .preprocess import build_chain_pair
from .records import ChainPair

logger = logging.getLogger(__name__)

ChainSource = Union[str, Sequence, Mapping, np.ndarray]


# Raw-parse binary cache: text parsing is the dominant steady-state host
# cost of a grid run (~9 s of ~24 s for the full Planck grid); a .npy cache
# keyed on (path, size, mtime) turns repeat parses into memory-speed reads.
# Opt-in via the MCE_PARSE_CACHE env var or set_parse_cache() (the CLI
# exposes --parse-cache).  The cache stores the RAW parsed table —
# burn/thin/split always run downstream, so changing those settings reuses
# the cache.
_PARSE_CACHE_DIR: Optional[str] = os.environ.get("MCE_PARSE_CACHE") or None


def set_parse_cache(path: Optional[str]) -> None:
    global _PARSE_CACHE_DIR
    _PARSE_CACHE_DIR = path or None


def _parse_cache_path(path: str) -> Optional[str]:
    if not _PARSE_CACHE_DIR:
        return None
    import hashlib
    st = os.stat(path)
    key = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
    # mtime_ns: a file rewritten within the same second (same byte size)
    # must not be served stale
    return os.path.join(_PARSE_CACHE_DIR,
                        f"{key}-{st.st_size}-{st.st_mtime_ns}.npy")


def parse_chain_file(path: str) -> np.ndarray:
    """Parse one whitespace-delimited chain file to a float64 matrix.

    A parse from text counts ``parse_files``, ``parse_slices`` (the row
    slices it was decoded in, one where the native parser did not take
    it), ``parse_fields`` and ``parse_fields_fixed`` (``utils/spans.py``);
    a read from the parse cache counts nothing."""
    cpath = _parse_cache_path(path)
    if cpath and os.path.exists(cpath):
        try:
            return np.load(cpath)
        except Exception as e:          # truncated/corrupt cache: re-parse
            logger.warning("parse cache read failed for %s: %s", cpath, e)
    from ..native import chainload
    from ..utils.spans import count
    got = chainload.parse_table(path)
    if got is None:
        # pandas C engine is ~10x faster than np.loadtxt on big chains
        try:
            import pandas as pd
            arr = pd.read_csv(path, sep=r"\s+", header=None, comment="#",
                              dtype=np.float64).to_numpy()
        except Exception:
            arr = np.loadtxt(path)
        nfixed, slices = 0, 1
    else:
        arr, nfixed, slices = got
    # the file, its slices, the fields converted from text, and those of
    # them the native parser's fixed-layout decoder took, under the
    # caller's collector
    count("parse_files")
    count("parse_slices", slices)
    count("parse_fields", arr.size)
    count("parse_fields_fixed", nfixed)
    if cpath:
        try:
            import threading
            os.makedirs(_PARSE_CACHE_DIR, exist_ok=True)
            # pid AND thread id: concurrent serve workers (--workers N) in
            # one process may parse the same file; each writer needs its
            # own tmp before the atomic publish
            tmp = (f"{cpath}.{os.getpid()}-{threading.get_ident()}"
                   ".tmp.npy")
            np.save(tmp, arr)
            os.replace(tmp, cpath)      # atomic: concurrent writers race-safe
        except Exception as e:
            logger.warning("parse cache write failed for %s: %s", cpath, e)
    return arr


def resolve_chain_files(fname: Union[str, Sequence[str]],
                        idchain: int = 0,
                        idpattern: str = "_?.txt") -> List[str]:
    """Resolve a chain root/pattern/list to a concrete file list
    (reference MCEvidence.py:574-596)."""
    if isinstance(fname, (list, tuple)):
        return list(fname)
    if os.path.isfile(fname):
        return [fname]
    if "*" in fname or "?" in fname:
        flist = sorted(_glob.glob(fname))
    elif idchain > 0:
        flist = [f"{fname}_{idchain}.txt"]
    else:
        # glob.escape the root: run directories may contain glob
        # metacharacters ([]), which would misfire as character classes —
        # only idpattern's own wildcards are meant to expand (the Cobaya
        # resolver has the same fix, cobaya.py)
        flist = sorted(_glob.glob(_glob.escape(fname) + idpattern))
    if not flist:
        raise FileNotFoundError(f"no chain files match {fname!r} "
                                f"(idchain={idchain}, idpattern={idpattern!r})")
    return flist


def _getdist_mcsamples_cls():
    """getdist's MCSamples class when the package is importable, else None.

    Looks at sys.modules first so an already-imported (or test-stubbed)
    getdist wins without re-import machinery; the class lives at
    ``getdist.MCSamples`` (re-exported) and ``getdist.mcsamples.MCSamples``.
    """
    import sys
    gd = sys.modules.get("getdist")
    if gd is None:
        try:
            import getdist as gd
        except Exception:
            return None
    cls = getattr(gd, "MCSamples", None)
    if cls is None:
        cls = getattr(getattr(gd, "mcsamples", None), "MCSamples", None)
    return cls if isinstance(cls, type) else None


def load_chains(source: ChainSource, idchain: int = 0,
                idpattern: str = "_?.txt") -> List[np.ndarray]:
    """Load raw per-chain column matrices [weight, -lnL, theta...] from any
    supported source."""
    if isinstance(source, str):
        # Cobaya root (<root>.updated.yaml + <root>.N.txt): column layout
        # and lnL recovery differ from CosmoMC — dedicated loader
        from .cobaya import is_cobaya_root, load_cobaya_chains
        if is_cobaya_root(source):
            return load_cobaya_chains(source, idchain=idchain)
        if _is_hdf5_file(source):
            return _hdf5_to_chains(source, idchain=idchain)
        # MultiNest/PolyChord roots (detected via their stats/equal-weights
        # products): -2lnL column convention + posterior-mass weights
        from .nested import load_nested_chains, nested_kind
        nkind = nested_kind(source)
        if nkind is not None:
            return load_nested_chains(source, kind=nkind, idchain=idchain)
    if isinstance(source, str) or (
            isinstance(source, (list, tuple)) and source
            and isinstance(source[0], str)):
        flist = resolve_chain_files(source, idchain=idchain, idpattern=idpattern)
        logger.info("reading chain files: %s", ", ".join(flist))
        return [parse_chain_file(f) for f in flist]

    if isinstance(source, Mapping):
        return [_dict_to_columns(source)]

    if isinstance(source, np.ndarray):
        return [np.asarray(source, dtype=np.float64)]

    # duck-typed ArviZ InferenceData (PyMC / NumPyro / emcee exports):
    # groups are xarray Datasets — anything whose .posterior has .data_vars
    # of (chain, draw, ...) arrays works, no arviz/xarray import required.
    post = getattr(source, "posterior", None)
    if post is not None and hasattr(post, "data_vars"):
        return _inferencedata_to_chains(source)

    # the actual getdist package (isinstance-gated): the reference
    # optionally consumed getdist MCSamples objects (reference
    # MCEvidence.py:45-59 — effectively dead there, shadowed at :536).
    # getdist's WeightedSamples contract: .samples (N, d), .loglikes =
    # -lnL (or None when the chain carried no likelihood column), and
    # .weights ALWAYS an array (the package defaults it to ones).  The
    # explicit gate pins that contract ahead of every duck branch so a
    # real getdist object can never drift into another interpretation;
    # getdist is optional — when not installed this is a no-op.
    gd_cls = _getdist_mcsamples_cls()
    if gd_cls is not None and isinstance(source, gd_cls):
        samples = np.atleast_2d(np.asarray(source.samples, np.float64))
        n = samples.shape[0]
        if source.loglikes is None:
            raise ValueError(
                "getdist MCSamples has loglikes=None: evidence needs -lnL "
                "per sample (load the chain with a likelihood column)")
        neg_lnl = np.asarray(source.loglikes, np.float64).reshape(n)
        w = np.asarray(source.weights, np.float64).reshape(n)
        return [np.column_stack([w, neg_lnl, samples])]

    # duck-typed dynesty Results: .samples (N, d), .logl (+lnL), .logwt
    # (unnormalized ln posterior mass per dead point) — the in-memory
    # sibling of the MultiNest/PolyChord file products (chains/nested.py);
    # weights are normalized in log space to avoid underflow (logwt spans
    # hundreds of nats on real runs).  Checked BEFORE the getdist duck
    # branch: dynesty has no .loglikes, so there is no overlap, but logwt
    # must win over a hypothetical .weights attribute.
    if (hasattr(source, "samples") and hasattr(source, "logl")
            and hasattr(source, "logwt")):
        samples = np.atleast_2d(np.asarray(source.samples, np.float64))
        n = samples.shape[0]
        lnl = np.asarray(source.logl, np.float64).reshape(n)
        logwt = np.asarray(source.logwt, np.float64).reshape(n)
        w = np.exp(logwt - logwt.max())
        # real runs span logwt ranges of thousands of nats: rows > ~745
        # nats below the peak underflow to exactly 0, and zero weights
        # poison the estimator (1/w) — drop them (they carry no posterior
        # mass at f64 resolution anyway)
        keep = w > 0.0
        if not np.all(keep):
            logger.info("dynesty ingestion: dropping %d of %d rows with "
                        "underflowed posterior mass", int((~keep).sum()), n)
            samples, lnl, w = samples[keep], lnl[keep], w[keep]
        w /= w.sum()
        return [np.column_stack([w, -lnl, samples])]

    # duck-typed getdist-style object: .samples (N, d), .loglikes (-lnL),
    # optional .weights — the reference consumed getdist MCSamples when that
    # package was installed (MCEvidence.py:45-59); here any object with the
    # same attributes works, no getdist import required.
    if hasattr(source, "samples") and hasattr(source, "loglikes"):
        samples = np.atleast_2d(np.asarray(source.samples, np.float64))
        n = samples.shape[0]
        neg_lnl = np.asarray(source.loglikes, np.float64).reshape(n)
        w = np.asarray(getattr(source, "weights", None)
                       if getattr(source, "weights", None) is not None
                       else np.ones(n), np.float64).reshape(n)
        return [np.column_stack([w, neg_lnl, samples])]

    if isinstance(source, (list, tuple)):
        return [np.asarray(c, dtype=np.float64) for c in source]

    raise TypeError(f"unsupported chain source type: {type(source)!r}")


def _is_hdf5_file(path: str) -> bool:
    if not os.path.isfile(path):
        return False
    if path.endswith((".h5", ".hdf5")):
        return True
    try:
        with open(path, "rb") as fp:
            return fp.read(8) == b"\x89HDF\r\n\x1a\n"
    except OSError:
        return False


def _hdf5_to_chains(path: str, idchain: int = 0) -> List[np.ndarray]:
    """emcee ``HDFBackend`` file -> per-walker column matrices.

    Layout (emcee >= 3): a group (default name ``mcmc``) holding ``chain``
    (iteration, walker, ndim) and ``log_prob`` (iteration, walker), with
    the live step count in the ``iteration`` attribute.  Each walker
    becomes its own chain so burn-in/thinning/per-chain error bars apply
    per walker; ``idchain`` > 0 selects a single walker (1-based, like the
    CosmoMC ``root_<id>.txt`` convention).  ``log_prob`` is consumed as
    +lnL exactly like the reference's emcee leg consumed
    ``flatlnprobability`` (reference examples.py:500-531): if the sampled
    density included a non-flat prior, ln Z inherits that prior ratio.
    """
    import h5py
    try:
        fh = h5py.File(path, "r")
    except OSError as e:      # .h5-named but corrupt/not actually HDF5
        raise ValueError(f"{path} is not a readable HDF5 file: {e}") from e
    with fh as fp:
        grp = None
        for name in ("mcmc", *fp.keys()):
            g = fp.get(name)
            if (isinstance(g, h5py.Group) and "chain" in g
                    and "log_prob" in g):
                grp = g
                break
        if grp is None:
            raise ValueError(
                f"{path} is HDF5 but has no emcee-backend group (needs "
                "'chain' + 'log_prob' datasets)")
        nit = int(grp.attrs.get("iteration", grp["chain"].shape[0]))
        chain = np.asarray(grp["chain"][:nit], np.float64)
        logp = np.asarray(grp["log_prob"][:nit], np.float64)
    if chain.ndim != 3 or logp.shape != chain.shape[:2]:
        raise ValueError(
            f"{path}: expected chain (steps, walkers, ndim) and matching "
            f"log_prob, got {chain.shape} / {logp.shape}")
    if nit == 0:
        raise ValueError(f"{path}: emcee backend holds 0 iterations")
    nwalk = chain.shape[1]
    walkers = range(nwalk) if idchain <= 0 else (idchain - 1,)
    if idchain > nwalk:
        raise ValueError(f"idchain={idchain} but {path} has {nwalk} walkers")
    ones = np.ones(nit)
    return [np.column_stack([ones, -logp[:, wk], chain[:, wk]])
            for wk in walkers]


def _inferencedata_to_chains(idata) -> List[np.ndarray]:
    """ArviZ ``InferenceData`` -> per-chain column matrices.

    ``posterior`` data variables (dims ``(chain, draw, *event)``) flatten
    into parameter columns in variable order; the per-draw total log
    likelihood is the sum of the ``log_likelihood`` group's pointwise
    values over observation dims and variables.  Each MCMC chain becomes
    its own matrix, so burn-in / thinning / per-chain error bars apply per
    chain exactly as for CosmoMC multi-file roots.  ``sample_stats.lp`` is
    deliberately NOT used as a fallback: it is the log *posterior*, whose
    prior term would bias ln Z (the evidence integrates the likelihood).
    """
    post = idata.posterior
    blocks = []
    for name in post.data_vars:
        var = post.data_vars[name]
        dims = getattr(var, "dims", None)
        if dims is not None and tuple(dims[:2]) != ("chain", "draw"):
            raise ValueError(
                f"posterior variable {name!r} has dims {tuple(dims)}; "
                "expected leading (chain, draw) — transpose the dataset "
                "first")
        v = np.asarray(var.values, np.float64)
        if v.ndim < 2:
            raise ValueError(f"posterior variable {name!r} needs "
                             "(chain, draw, ...) dims")
        blocks.append(v.reshape(v.shape[0], v.shape[1], -1))
    if not blocks:
        raise ValueError("InferenceData posterior has no data variables")
    theta = np.concatenate(blocks, axis=2)          # (chain, draw, ndim)

    ll = getattr(idata, "log_likelihood", None)
    if ll is None or not hasattr(ll, "data_vars"):
        raise ValueError(
            "InferenceData source needs a log_likelihood group (e.g. "
            "pm.sample(..., idata_kwargs={'log_likelihood': True}) or "
            "numpyro's log_likelihood helper); sample_stats.lp is the log "
            "posterior and would bias the evidence")
    tot = None
    for name in ll.data_vars:
        var = ll.data_vars[name]
        dims = getattr(var, "dims", None)
        if dims is not None and tuple(dims[:2]) != ("chain", "draw"):
            raise ValueError(
                f"log_likelihood variable {name!r} has dims {tuple(dims)}; "
                "expected leading (chain, draw)")
        v = np.asarray(var.values, np.float64)
        if v.ndim < 2:
            raise ValueError(f"log_likelihood variable {name!r} needs "
                             "(chain, draw, ...) dims")
        s = v.reshape(v.shape[0], v.shape[1], -1).sum(axis=2)
        tot = s if tot is None else tot + s        # (chain, draw)
    if tot.shape != theta.shape[:2]:
        raise ValueError(f"log_likelihood (chain, draw) shape {tot.shape} "
                         f"does not match posterior {theta.shape[:2]}")
    ones = np.ones(theta.shape[1])
    return [np.column_stack([ones, -tot[c], theta[c]])
            for c in range(theta.shape[0])]


def _dict_to_columns(d: Mapping) -> np.ndarray:
    """Assemble a CosmoMC column matrix from an explicit-key dict.

    ``samples`` (N, d) required; ``loglikes`` (N,) +lnL (defaults to 0);
    ``weights`` (N,) defaults to 1.  Stored as [w, -lnL, theta...].
    """
    if "samples" not in d:
        raise KeyError("dict chain needs a 'samples' key (plus optional "
                       "'loglikes' and 'weights')")
    samples = np.atleast_2d(np.asarray(d["samples"], dtype=np.float64))
    n = samples.shape[0]
    lnl = np.asarray(d.get("loglikes", np.zeros(n)), dtype=np.float64).reshape(n)
    w = np.asarray(d.get("weights", np.ones(n)), dtype=np.float64).reshape(n)
    return np.column_stack([w, -lnl, samples])


def ingest(source: ChainSource,
           burnlen: float = 0.0,
           thinlen: float = 0.0,
           split: bool = False,
           s1frac: float = 0.5,
           idchain: int = 0,
           idpattern: str = "_?.txt",
           rng: Optional[np.random.Generator] = None,
           split_ix: Optional[np.ndarray] = None) -> ChainPair:
    """One-call ingestion: load -> burn -> concat -> thin -> split."""
    chains = load_chains(source, idchain=idchain, idpattern=idpattern)
    return build_chain_pair(chains, burnlen=burnlen, thinlen=thinlen,
                            split=split, s1frac=s1frac, rng=rng,
                            split_ix=split_ix)
