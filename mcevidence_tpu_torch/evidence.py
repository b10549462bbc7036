"""Public evidence-estimation API of the PyTorch/CUDA port.

``MCEvidence`` is a drop-in facade matching the reference's constructor and
``evidence()`` signatures (reference MCEvidence.py:613-1168); ``evidence_fn``
is the functional core for users who already hold arrays.  Both mirror
``mcevidence_tpu.evidence`` on its default path, ``precision="refine"``:

  host ingest (burn/thin/split) -> host f64 whitening -> f32 kNN candidate
  selection and f64 refinement on ``device`` -> host f64 estimator

which matches a float64 sklearn/numpy oracle to ~1e-9 in ln Z; on
``precision="device"`` (``ops/pipeline.py``), which selects, refines in f64
and reduces on ``device`` and fetches only kmax+1 scalars (~1e-13 of
refine); and on ``precision="fast"``, which uses the exact selection's f32
distances directly (~1e-3 of refine): host f64 whitening and estimator in
``evidence_fn``, and for one auto-mode batch in ``MCEvidence`` the fused
f32 pipeline with whitening and estimator on ``device`` too.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .chains.preprocess import importance_sample
from .chains.reader import ingest
from .chains.records import ChainPair
from .ops.estimator import log_evidence_from_knn_np
from .ops.knn import exact_knn, resolve_engine
from .ops.whiten import WhitenStats, apply_whiten, whiten_stats
from .utils.batch import BatchPlan, make_batch_plan
from .utils.device import resolve_device
from .utils.logging import configure, verbosity_to_level
from .utils.spans import collect, count, span

logger = logging.getLogger(__name__)

PRECISIONS = ("refine", "fast", "device")
COVTYPES = ("all", "single")


def _check_mode(value, allowed, name):
    """Typos must fail loudly: an unknown precision/covtype must never fall
    through to a different pipeline."""
    if value not in allowed:
        raise ValueError(f"unknown {name} {value!r}; expected one of "
                         f"{allowed}")


def check_precision(precision: str) -> None:
    """Raise ``ValueError`` for an unknown precision."""
    _check_mode(precision, PRECISIONS, "precision")


def evidence_fn(samples: np.ndarray,
                lnlike: np.ndarray,
                weights: Optional[np.ndarray] = None,
                *,
                samples2: Optional[np.ndarray] = None,
                kmax: int = 5,
                prior_volume: float = 1.0,
                sum_adjusted_weights: Optional[float] = None,
                covtype: str = "all",
                prewhiten: bool = True,
                precision: str = "refine",
                engine: str = "auto",
                device="cuda") -> np.ndarray:
    """Functional evidence estimate from raw arrays.

    Auto mode when ``samples2`` is None, cross mode otherwise (NN of
    ``samples`` searched in ``samples2``).  Returns ln Z for k = 1..kmax-1.

    Args mirror the estimator: ``lnlike`` is +lnL; ``weights`` default to 1.
    ``covtype='all'`` whitens with the covariance of all samples (s1+s2),
    ``'single'`` whitens each partition with its own covariance (Jacobian
    from s1) — reference semantics (MCEvidence.py:1034-1037,1052-1054,
    1080-1086).  ``device`` is where the kNN selection (and in ``device``
    precision the refinement and reduction) runs: ``"cuda"`` (default;
    raises without a card) or ``"cpu"``.
    """
    kmax = max(2, kmax)
    check_precision(precision)
    _check_mode(covtype, COVTYPES, "covtype")
    resolve_engine(engine)
    resolve_device(device)
    samples = np.atleast_2d(np.asarray(samples, np.float64))
    n, ndim = samples.shape
    lnlike = np.asarray(lnlike, np.float64).reshape(n)
    w = (np.ones(n) if weights is None
         else np.asarray(weights, np.float64).reshape(n))
    sumw = float(np.sum(w)) if sum_adjusted_weights is None \
        else float(sum_adjusted_weights)

    cross = samples2 is not None
    if cross:
        samples2 = np.atleast_2d(np.asarray(samples2, np.float64))
    if precision == "device":
        if prewhiten and (not cross or covtype == "all"):
            from .ops.pipeline import device_refine_evidence
            return device_refine_evidence(
                samples, lnlike, w, samples2=samples2, kmax=kmax,
                prior_volume=prior_volume, sum_adjusted_weights=sumw,
                engine=engine, device=device)
        logger.info(
            "precision='device' unsupported for cross + covtype='single' "
            "whitening or prewhiten=False (per-partition stats are "
            "host-side); falling back to precision='refine' — timings will "
            "be refine-path timings")
        count("device_fallbacks")

    if prewhiten:
        if covtype == "all":
            all_s = np.concatenate([samples, samples2]) if cross else samples
            stats = whiten_stats(all_s)
            s1w = apply_whiten(samples, stats)
            s2w = apply_whiten(samples2, stats) if cross else None
        else:
            stats = whiten_stats(samples)
            s1w = apply_whiten(samples, stats)
            s2w = None
            if cross:
                stats2 = whiten_stats(samples2)
                s2w = apply_whiten(samples2, stats2)
        log_j = stats.log_jacobian
    else:
        s1w, s2w, log_j = samples, samples2, 0.0

    dknn = exact_knn(s1w, s2w if cross else None, kmax,
                     refine=precision != "fast", engine=engine, device=device)
    k_start = 0 if cross else 1
    mle = log_evidence_from_knn_np(
        dknn, lnlike, w, sumw, ndim,
        log_jacobian=log_j, log_prior_volume=math.log(prior_volume),
        k_start=k_start, nsamples=n)
    # exact_knn clips k to the reference-partition size; NaN-pad so the
    # k = 1..kmax-1 return contract holds
    out = np.full(kmax - 1, np.nan)
    out[: len(mle) - 1] = mle[1:]
    return out


class MCEvidence:
    """Evidence estimation from MCMC chains (facade compatible with the
    reference class, MCEvidence.py:613-783).

    :param method: chain file root/list/glob (str), raw arrays
        (list/tuple/dict with 'samples'/'loglikes'/'weights' keys), or — with
        ``ischain=False`` — a sampler class/instance exposing
        ``Sampler(nsamples) -> (samples, lnlike)``.
    :param split: cross-evidence mode — the chain is randomly split and NNs of
        s1 are searched in s2.  (The reference claims a sqrt(2) smaller
        error, MCEvidence.py:956-962; measured, that holds only for two
        independent full-size chains, not for a split —
        docs/VALIDATION_STUDY.md "Auto vs cross scatter".)
    :param kmax: evidence is returned for k = 1..kmax-1 (floored at 2,
        reference MCEvidence.py:694).
    :param seed: RNG seed for split / Poisson thinning / random subsampling
        (the reference uses the unseeded global RNG — quirk Q8).
    :param precision: 'refine' (float64-parity, default), 'device' (the
        refinement and reduction on the card too, scalars-only fetch) or
        'fast' (the selection's f32 distances used directly).
    :param engine: kNN selection engine: 'auto', 'cuda' (alias 'pallas')
        and 'pallas_exact' (the exact k-dependent kernel dispatch),
        'pallas_smalld' (the small-d kernel for refine consumers at
        d <= 16), 'pallas_packed' and 'pallas_packed2' (the truncated-key
        kernels of K6/K7 and K1), 'pallas_binned' (the large-k kernel at any
        k) or 'torch' (alias 'xla': the plain PyTorch selection); see
        ``ops.knn`` for the kernel each takes on each path.
    :param device: where the kNN selection runs, 'cuda' (default) or 'cpu'.
    """

    def __init__(self, method, ischain: bool = True,
                 isfunc: Optional[Callable] = None,
                 thinlen: float = 0.0, burnlen: float = 0.0,
                 split: bool = False, s1frac: float = 0.5,
                 shuffle: bool = True,
                 ndim: Optional[int] = None, kmax: int = 5,
                 priorvolume: float = 1,
                 debug: bool = False,
                 nsample: Optional[int] = None,
                 covtype: str = "single",
                 nbatch: int = 1, brange=None, bscale: str = "",
                 verbose: int = 1, args=(),
                 seed: Optional[int] = None,
                 precision: str = "refine",
                 engine: str = "auto",
                 device="cuda",
                 **gdkwargs):
        configure(2 if (debug or verbose > 1) else verbose)
        self.verbose = verbose
        self.debug = debug or verbose > 1
        logger.setLevel(verbosity_to_level(2 if self.debug else verbose))

        check_precision(precision)
        _check_mode(covtype, COVTYPES, "covtype")
        resolve_engine(engine)
        self.device = resolve_device(device)
        self.split = split
        self.covtype = covtype
        self.nbatch = nbatch
        self.brange = brange
        self.bscale = bscale if not isinstance(brange, int) else "constant"
        self.kmax = max(2, kmax)
        self.priorvolume = priorvolume
        self.ischain = ischain
        self.precision = precision
        self.engine = engine
        self.rng = np.random.default_rng(seed)
        self.info: dict = {}
        # the steps' seconds and the page-fault count (``utils/spans.py``)
        # of the ingest and the latest evidence(), and its spans
        self.timings: dict = {}
        self.spans: list = []
        self.fname = method if isinstance(method, str) else None
        self.snames = ["s1", "s2"] if split else ["s1"]

        if not ischain:
            # sampler-class path, fixed from the reference's broken
            # nsample/nsamples typo (quirk Q3, MCEvidence.py:715-743).
            self.nsample_req = 100000 if nsample is None else nsample
            sampler_obj = method(*args) if isinstance(method, type) else method
            samples, lnlike = sampler_obj.Sampler(nsamples=self.nsample_req)
            method = {"samples": np.asarray(samples),
                      "loglikes": np.asarray(lnlike)}

        with collect(self.timings, self.spans), span("ingest"):
            idchain = gdkwargs.pop("idchain", 0)
            idpattern = gdkwargs.pop("idpattern", "_?.txt")
            self.pair: ChainPair = ingest(
                method, burnlen=burnlen, thinlen=thinlen, split=split,
                s1frac=s1frac, idchain=idchain, idpattern=idpattern,
                rng=self.rng)
        self._ingest_timings = dict(self.timings)

        if isfunc is not None:
            self.pair = importance_sample(self.pair, isfunc,
                                          names=tuple(self.snames))

        # the reference reports the s1 partition's shape here, not the total
        # (get_shape() defaults to 's1'; MCEvidence.py:762-764)
        nparam = self.pair.get_shape("s1")[1]
        self.info["NparamsMC"] = nparam
        self.info["Nsamples_read"] = self.pair.get_shape("s1")[0]
        self.info["Nparams_read"] = nparam
        self.nsample = [self.pair.get_shape(s)[0] for s in self.snames]
        if ndim is not None and ndim > nparam:
            # the distances can only use the nparam columns that exist;
            # letting ndim exceed it would put d=ndim in the ball volume but
            # d=nparam in the distances -> silently wrong ln Z
            logger.warning(
                "ndim=%d exceeds the chain's %d parameters; clamping to %d",
                ndim, nparam, nparam)
            ndim = nparam
        self.ndim = nparam if ndim is None else ndim
        self.info["NparamsCosmo"] = self.ndim
        self.info["Nsamples"] = ", ".join(str(x) for x in self.nsample)
        # nested-sampler roots carry their own evidence estimate — surface
        # it for the method-paper cross-check (key absent for other sources)
        if self.fname is not None:
            from .chains.nested import sampler_lnz
            own = sampler_lnz(self.fname)
            if own is not None:
                self.info["sampler_lnZ"], self.info["sampler_lnZ_err"] = own
        logger.info("chain array dimensions: %s x %s", self.nsample, self.ndim)

        self.batch_plan: BatchPlan = make_batch_plan(
            self.nsample, nbatch=self.nbatch, brange=self.brange,
            bscale=self.bscale)

    # ------------------------------------------------------------------
    def summary(self):
        print()
        print(f"ndim={self.ndim}")
        print(f"nsample={self.nsample}")
        print(f"kmax={self.kmax}")
        print(f"brange={self.brange}")
        print(f"bsize={self.batch_plan.bsize}")
        print(f"powers={self.batch_plan.powers}")
        print(f"nchain={self.batch_plan.nchain}")
        print()

    # ------------------------------------------------------------------
    def _get_batch(self, name: str, nsamples: int, rand: bool):
        """Row subset of a partition, trimmed to ndim leading params
        (reference get_samples, MCEvidence.py:884-947, prewhiten=False)."""
        part = self.pair.partition(name)
        ntot = part.nsamples
        s, lnp, w = part.samples[:, :self.ndim], part.lnp(), part.weights
        if nsamples <= 0:
            return s, lnp, w
        if rand and self.brange is not None:
            if nsamples > ntot:
                raise ValueError(
                    f"partition {name}: nsamples={nsamples} > ntotal={ntot}")
            idx = self.rng.integers(0, ntot, size=nsamples)
        else:
            # truncate, don't crash: 'constant' bscale batch sizes are
            # cumulative and the last one can exceed the partition length
            idx = np.arange(min(nsamples, ntot))
        return s[idx], lnp[idx], w[idx]

    def _stats_all(self) -> WhitenStats:
        """Covariance stats over all samples of all partitions
        (reference get_covariance with s=None, MCEvidence.py:851-866)."""
        return whiten_stats(self.pair.all_samples()[:, :self.ndim])

    # ------------------------------------------------------------------
    def evidence(self, verbose: Optional[int] = None, rand: bool = False,
                 info: bool = False, covtype: str = "all",
                 profile: bool = False, pvolume: Optional[float] = None,
                 pos_lnp: bool = False, nproc: int = -1,
                 prewhiten: bool = True):
        """Estimate ln Z (reference MCEvidence.py:950-1168).

        Returns a 1-D array of ln Z for k = 1..kmax-1 when ``brange`` is None,
        else a 2-D (nbatch, kmax-1) array; with ``info=True`` additionally
        returns the info dict.  ``covtype`` defaults to 'all' regardless of
        the constructor value unless explicitly passed None (quirk Q1).
        ``profile=True`` logs the per-stage wall times (the reference accepts
        profile= and ignores it, MCEvidence.py:950-952) and, when
        ``MCE_PROFILE_DIR`` is set, writes a ``torch.profiler`` Chrome trace
        of the run (CPU activity, and CUDA activity on a card) into that
        directory, named with the process id and a time stamp; the trace
        holds the estimate's spans as ``mce.<name>`` annotations.

        Each call replaces ``self.timings`` and ``self.spans`` with this
        estimate's (``utils/spans.py``), keeping the constructor's
        ``ingest``: ``timings`` holds ``<span>_s``, each span's seconds
        summed over its runs, for the spans that ran (``evidence``;
        ``whiten``, ``knn``, ``estimator`` or ``fused``; inside them
        ``host_prep``, ``upload``, ``select``, ``host_refine``,
        ``reselect``, ``device_prep``, ``device_run``); ``spans`` holds
        ``(name, parent, start, end)`` on the ``perf_counter`` clock.
        """
        if verbose is None:
            verbose = self.verbose
        log_pv = math.log(self.priorvolume if pvolume is None else pvolume)
        if covtype is None:
            covtype = self.covtype
        _check_mode(covtype, COVTYPES, "covtype")

        args = (verbose, rand, info, covtype, profile, log_pv, pos_lnp,
                prewhiten)
        trace_dir = os.environ.get("MCE_PROFILE_DIR") if profile else None
        if not trace_dir:
            return self._collected(args)
        from torch.profiler import ProfilerActivity, profile as torch_profile
        on_card = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with torch_profile(activities=activities) as prof:
            out = self._collected(args)
            if on_card:
                torch.cuda.synchronize(self.device)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"mce_trace_{os.getpid()}_"
                                       f"{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
        return out

    def _collected(self, args):
        """``_evidence_impl(*args)`` as one estimate under the ``evidence``
        span: the timings and spans of an earlier call are dropped, the
        constructor's ingest kept."""
        self.timings.clear()
        self.timings.update(self._ingest_timings)
        del self.spans[1:]                 # the ingest span stays first
        with collect(self.timings, self.spans), span("evidence"):
            return self._evidence_impl(*args)

    def _evidence_impl(self, verbose, rand, info, covtype, profile, log_pv,
                       pos_lnp, prewhiten):
        kmax, ndim = self.kmax, self.ndim
        if (self.precision == "device" and self.brange is None and prewhiten
                and (not self.split or covtype == "all")):
            # one batch covering the whole chain; covtype 'all', which for
            # auto mode coincides with 'single'
            from .ops.pipeline import device_refine_evidence
            s, lnl, w = self._get_batch("s1", 0, False)
            s2 = self._get_batch("s2", 0, False)[0] if self.split else None
            if pos_lnp:
                lnl = -lnl
            with span("fused"):
                out = device_refine_evidence(
                    s, lnl, w, samples2=s2, kmax=kmax,
                    prior_volume=math.exp(log_pv),
                    sum_adjusted_weights=float(
                        np.sum(self.pair.s1.adjusted_weights)),
                    engine=self.engine, device=self.device)
            if verbose > 0:
                for k in range(1, kmax):
                    logger.info("   ln(B)[k=%d] = %s", k, out[k - 1])
            if info:
                return out, self.info
            return out
        if self.precision == "device":
            logger.info(
                "precision='device' unsupported for this request (batched "
                "brange, prewhiten=False, or cross + covtype='single'); "
                "falling back to precision='refine'")
            count("device_fallbacks")

        # the fused f32 pipeline for the common fast-mode case: one batch
        # covering the whole chain, auto mode (covtype 'all' and 'single'
        # coincide)
        if (self.precision == "fast" and not self.split
                and self.brange is None and prewhiten):
            from .ops.pipeline import fast_auto_evidence
            s, lnl, w = self._get_batch("s1", 0, False)
            if pos_lnp:
                lnl = -lnl
            with span("fused"):
                out = fast_auto_evidence(
                    s, lnl, w, kmax=kmax, prior_volume=math.exp(log_pv),
                    sum_adjusted_weights=float(
                        np.sum(self.pair.s1.adjusted_weights)),
                    engine=self.engine, device=self.device)
            if verbose > 0:
                for k in range(1, kmax):
                    logger.info("   ln(B)[k=%d] = %s", k, out[k - 1])
            if info:
                return out, self.info
            return out

        mle = np.zeros((self.batch_plan.nbatch, kmax))
        # the spans below add to these, summed over the batches
        self.timings.update(whiten_s=0.0, knn_s=0.0, estimator_s=0.0)

        if covtype == "all" and prewhiten:
            # (prewhiten=False never reads stats — skip the O(N d^2) + eigh)
            with span("whiten"):
                stats = self._stats_all()

        sum_w = float(np.sum(self.pair.s1.adjusted_weights))

        for ib, S in enumerate(self.batch_plan.batch_sizes_s1()):
            S = int(S)
            samples, lnl, weight = self._get_batch("s1", S, rand)
            S_eff = samples.shape[0]
            if pos_lnp:
                lnl = -lnl

            with span("whiten"):
                if prewhiten:
                    if covtype == "single":
                        stats = whiten_stats(samples)
                    s1w = apply_whiten(samples, stats)
                else:
                    s1w = samples

            if self.split:
                samples2, _, _ = self._get_batch("s2", 0, rand)
                with span("whiten"):
                    if prewhiten:
                        # covtype='single': s2 whitened by its own
                        # covariance, Jacobian stays from s1's stats
                        # (reference MCEvidence.py:1080-1086, commented-out
                        # Jacobian line).
                        stats2 = (whiten_stats(samples2)
                                  if covtype == "single" else stats)
                        s2w = apply_whiten(samples2, stats2)
                    else:
                        s2w = samples2
                k_start = 0
                ref = s2w
            else:
                k_start = 1
                ref = None

            log_j = stats.log_jacobian if prewhiten else 0.0

            with span("knn"):
                dknn = exact_knn(s1w, ref, kmax,
                                 refine=self.precision != "fast",
                                 engine=self.engine, device=self.device)

            with span("estimator"):
                # exact_knn clips k to the reference-partition size (tiny
                # split halves / small batches): fill the defined columns,
                # NaN the rest
                row = log_evidence_from_knn_np(
                    dknn, lnl, weight, sum_w, ndim,
                    log_jacobian=log_j, log_prior_volume=log_pv,
                    k_start=k_start, nsamples=S_eff)
                mle[ib, : len(row)] = row
                mle[ib, len(row):] = np.nan

        if profile:
            logger.info("profile: %s", self.timings)

        # column k=0 dropped always (quirk Q2: in cross mode this discards
        # the genuine 1st-NN estimate, preserved for parity).
        out = mle[0, 1:] if self.brange is None else mle[:, 1:]
        if verbose > 0:
            flat = np.atleast_2d(out)
            for k in range(1, kmax):
                logger.info("   ln(B)[k=%d] = %s", k, flat[-1][k - 1])
        if info:
            return out, self.info
        return out


def evidence_with_error(source, *, kmax: int = 2, nchains: int = 0,
                        idpattern: str = "_?.txt", **kwargs):
    """ln Z with a statistical error bar from per-chain scatter.

    Runs the estimator independently on each chain file of ``source`` (a
    CosmoMC root, file list, or list of raw arrays) and reports
    (mean, err, per_chain) per k, with err = std / sqrt(nchains) — the
    reference's SingleChains error recipe (planck_mcevidence.py:369-372).

    ``nchains``: use only the first n chains (0 = all).  Extra kwargs go to
    ``MCEvidence`` (burnlen, thinlen, priorvolume, engine, device, ...).
    """
    from .chains.reader import load_chains

    chains = load_chains(source, idpattern=idpattern)
    if nchains > 0:
        chains = chains[:nchains]
    if len(chains) < 2:
        raise ValueError("evidence_with_error needs >= 2 chains for a "
                         f"scatter estimate, got {len(chains)}")
    per_chain = np.stack([
        MCEvidence([c], kmax=kmax, verbose=0, **kwargs).evidence()
        for c in chains])
    mean = per_chain.mean(axis=0)
    # ddof=1: the reference recipe uses the pandas sample std
    # (planck_mcevidence.py:370-372)
    err = per_chain.std(axis=0, ddof=1) / math.sqrt(len(chains))
    return mean, err, per_chain


def evidence_bootstrap(source, *, kmax: int = 2, n_boot: int = 100,
                       seed: int = 0, idpattern: str = "_?.txt",
                       engine: str = "auto", precision: str = "refine",
                       device="cuda", **kwargs):
    """ln Z with a Bayesian-bootstrap error bar from ONE chain.

    Holds the sample positions (and hence the kNN volumes) fixed and
    perturbs each chain row's probability mass with Dirichlet weights
    (``g_j ~ Exp(1)``, Rubin 1981): the estimator is a product of two row
    means, ``Z = S^2/(S k + 1) * E_F[w] * E_F[V_k e^{lnL-lnLmax}/w]``
    (reference MCEvidence.py:1117-1131), and each replicate re-draws F from
    the Dirichlet posterior over the observed rows.  Reweighting keeps the
    point set unique and lets all replicates share the single kNN pass, so
    ``n_boot`` replicates cost one selection plus cheap host reductions.
    (The kNN distance noise itself is not resampled; the reported error
    captures the dominant likelihood-sum variance.)

    With ``split=True`` (cross-evidence) the replicates perturb the query
    partition's row masses; the reference partition only contributes
    positions to the (weight-independent) kNN distances.

    Returns ``(lnz, err, replicates)``: ``lnz`` the unperturbed estimate for
    k = 1..kmax-1, ``err`` the replicate standard deviation per k,
    ``replicates`` the (n_boot, kmax-1) array.
    """
    cross = bool(kwargs.get("split"))
    # reproducibility: the ingest-time RNG (split / Poisson thinning) shares
    # the bootstrap seed unless the caller provides its own
    kwargs.setdefault("seed", seed)
    mc = MCEvidence(source, kmax=kmax, verbose=0, engine=engine,
                    idpattern=idpattern, precision=precision, device=device,
                    **kwargs)
    kmax = mc.kmax
    s, lnl, w = mc._get_batch("s1", 0, False)
    if np.any(w <= 0):
        raise ValueError("evidence_bootstrap requires strictly positive "
                         "weights")
    if cross:
        s2 = mc._get_batch("s2", 0, False)[0]
        stats = whiten_stats(np.concatenate([s, s2]))   # covtype='all', Q1
        s2w = apply_whiten(s2, stats)
    else:
        s2w = None
        stats = whiten_stats(s)
    s1w = apply_whiten(s, stats)
    # the shared kNN pass honours the requested precision (fast: the
    # selection's f32 distances); all replicates reuse it either way
    dknn = exact_knn(s1w, s2w, kmax, refine=precision != "fast",
                     engine=engine, device=mc.device)
    # exact_knn clips k to the reference-partition size; keep the replicate
    # matrix consistent with the columns actually computed so short chains
    # (or small split halves) return fewer k values instead of raising.
    kmax = dknn.shape[1]
    log_pv = math.log(mc.priorvolume)
    n = s.shape[0]
    # importance reweighting enters only through SumW (quirk Q7); carry the
    # per-point adjusted/raw ratio into each replicate's SumW.
    adj_ratio = mc.pair.s1.adjusted_weights / mc.pair.s1.weights

    def estimate(wts, sumw):
        return log_evidence_from_knn_np(
            dknn, lnl, wts, sumw, mc.ndim,
            log_jacobian=stats.log_jacobian, log_prior_volume=log_pv,
            k_start=0 if cross else 1, nsamples=n)[1:]

    lnz = estimate(w, float(np.sum(w * adj_ratio)))
    rng = np.random.default_rng(seed)
    reps = np.empty((n_boot, kmax - 1))
    for b in range(n_boot):
        g = rng.exponential(size=n)
        # row j's term in dotp gains a factor g_j (weights w/g divide by
        # w/g), SumW becomes sum(g*w); the 2(ln S - ln sum g) shift restores
        # the Dirichlet normalization of both row means.
        shift = 2.0 * (math.log(n) - math.log(float(np.sum(g))))
        reps[b] = estimate(w / g, float(np.sum(g * w * adj_ratio))) + shift
    err = reps.std(axis=0, ddof=1)
    return lnz, err, reps
