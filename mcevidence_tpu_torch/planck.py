"""Planck full-grid batch driver.

The counterpart of ``mcevidence_tpu/planck.py``, which re-implements the
reference's MPI grid driver (planck_mcevidence.py:1-485): evidence for every model x dataset cell of the Planck R2 full grid, with
per-dataset tables (txt + csv), per-chain mean/error columns, delta-lnE
aggregation, pickles, and the Riess-2016 H0 importance-prior hook.

One process drives one card (``--device``, default ``cuda``) through every
cell.  At the defaults (``--precision device --batch-cells``) a per-chain
run (``-nc N``) sends each dataset's cells in chunks of ``MCE_GRID_QUANTUM``
(default 4) through one batched selection launch each
(``parallel/ring.py:sharded_grid_device_refine_evidence``, the batched
kernel); AllChains cells go one by one through the device path, all
launched before any is fetched.  ``--precision fast`` batches each
dataset's cells of one dimensionality and row bucket into one launch of the
f32 program (``parallel/ring.py:sharded_grid_auto_evidence``).
``--num-shards/--shard-id`` shard the
dataset list deterministically (the reference's MPI ranks, with its
remainder bug Q10 fixed), ``--procs`` forks the shards, ``--distributed``
takes one shard a rank of a ``torch.distributed`` job started by torchrun
(each rank on ``cuda:LOCAL_RANK``), and ``--aggregate-only`` merges their
outputs.

Chain text parsing, the host-side bottleneck, uses the native C++ loader
with a prefetch thread, so the next model's files parse while the card works
on the current one.  pandas is imported only where tables are built, read
or pickled: the evidence matrix needs numpy and torch alone.

Spans (``utils/spans.py``): ``dataset_evidence`` holds a collector for its
dataset, under which the stages are ``grid_parse_wait`` (blocked on a parse
future), ``grid_prologue`` (``.paramnames``, ``.ranges``, the H0 column and
the H0 reweight), ``grid_launch`` (a cell's prepare and launch; at refine
and fast, and for wide cells, the batched or per-cell call, which launches
and fetches in one), ``grid_fetch`` (the fetch and the finalize),
``grid_rerun`` (the synchronous re-run of a thin-margin cell) and
``grid_tables`` (the frame; in ``run_grid`` and ``main`` also the txt, the
csv and the aggregate, under the caller's collector), with the counts
``grid_cells`` and ``grid_reruns``, and ``parse_files``, ``parse_slices``,
``parse_fields`` and ``parse_fields_fixed`` (``chains/reader.py``), which
the prefetch threads hand back with each parse.  ``_stage_log`` logs the
stages.
"""

from __future__ import annotations

import glob as _glob
import logging
import os
import pickle
import sys
from argparse import ArgumentParser
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np

from .priors.params_info import params_info
from .utils.logging import configure
from .utils.spans import collect, count, span

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# the canonical Planck R2 grid (reference planck_mcevidence.py:173-196)
# ---------------------------------------------------------------------------

DEFAULT_ROOTDIR = "COM_CosmoParams_fullGrid_R2.00"

DATASETS: List[str] = [
    "plikHM_TT_lowTEB", "plikHM_TT_lowTEB_post_BAO",
    "plikHM_TT_lowTEB_post_lensing", "plikHM_TT_lowTEB_post_H070p6",
    "plikHM_TT_lowTEB_post_JLA", "plikHM_TT_lowTEB_post_zre6p5",
    "plikHM_TT_lowTEB_post_BAO_H070p6_JLA",
    "plikHM_TT_lowTEB_post_lensing_BAO_H070p6_JLA",
    "plikHM_TT_lowTEB_BAO", "plikHM_TT_lowTEB_BAO_post_lensing",
    "plikHM_TT_lowTEB_BAO_post_H070p6",
    "plikHM_TT_lowTEB_BAO_post_H070p6_JLA",
    "plikHM_TT_lowTEB_lensing", "plikHM_TT_lowTEB_lensing_post_BAO",
    "plikHM_TT_lowTEB_lensing_post_zre6p5",
    "plikHM_TT_lowTEB_lensing_post_BAO_H070p6_JLA",
    "plikHM_TT_tau07plikHM_TT_lowTEB_lensing_BAO",
    "plikHM_TT_lowTEB_lensing_BAO_post_H070p6",
    "plikHM_TT_lowTEB_lensing_BAO_post_H070p6_JLA",
    "plikHM_TTTEEE_lowTEB", "plikHM_TTTEEE_lowTEB_post_BAO",
    "plikHM_TTTEEE_lowTEB_post_lensing", "plikHM_TTTEEE_lowTEB_post_H070p6",
    "plikHM_TTTEEE_lowTEB_post_JLA", "plikHM_TTTEEE_lowTEB_post_zre6p5",
    "plikHM_TTTEEE_lowTEB_post_BAO_H070p6_JLA",
    "plikHM_TTTEEE_lowTEB_post_lensing_BAO_H070p6_JLA",
    "plikHM_TTTEEE_lowl_lensing", "plikHM_TTTEEE_lowl_lensing_post_BAO",
    "plikHM_TTTEEE_lowl_lensing_post_BAO_H070p6_JLA",
    "plikHM_TTTEEE_lowTEB_lensing",
]

MODELS: List[str] = [
    "base", "base_omegak", "base_Alens", "base_Alensf", "base_nnu",
    "base_mnu", "base_nrun", "base_r", "base_w", "base_alpha1",
    "base_Aphiphi", "base_yhe", "base_mnu_Alens", "base_mnu_omegak",
    "base_mnu_w", "base_nnu_mnu", "base_nnu_r", "base_nrun_r",
    "base_nnu_yhe", "base_w_wa", "base_nnu_meffsterile",
    "base_nnu_meffsterile_r",
]

INFO_COLS = ["PriorVol", "ndim", "N_read", "N_used"]

STAGES = ("grid_parse_wait", "grid_prologue", "grid_launch", "grid_fetch",
          "grid_rerun", "grid_tables")


# ---------------------------------------------------------------------------
# H0 importance prior (reference planck_mcevidence.py:56-58, fixed for the
# ndarray reader: the reference's attribute access .H0 only worked against a
# getdist ParSamples object — quirk in SURVEY.md §2.2)
# ---------------------------------------------------------------------------

def read_paramnames(root: str) -> List[str]:
    """Parameter names from the CosmoMC ``<root>.paramnames`` file (one
    ``name  latex`` pair per line, '*' suffix marks derived params)."""
    path = root + ".paramnames"
    names = []
    with open(path, "r") as fp:
        for line in fp:
            parts = line.split()
            if parts:
                names.append(parts[0].rstrip("*"))
    return names


def make_h0_gauss_lnp(h0_index: int, H0: float = 73.24, H0_err: float = 1.74):
    """Gaussian H0 prior (Riess 2016) as a -lnL importance hook.

    ``h0_index`` is the column of H0 within the chain's parameter block
    (resolve with ``read_paramnames``).  Returns f(samples)->(N,) 0.5*z^2.
    """
    def h0_gauss_lnp(samples: np.ndarray) -> np.ndarray:
        frac = (samples[:, h0_index] - H0) / H0_err
        return 0.5 * frac ** 2
    return h0_gauss_lnp


def h0_index_for_chain(root: str) -> Optional[int]:
    """Column index of H0* among the chain parameters, or None."""
    try:
        names = read_paramnames(root)
    except OSError:
        return None
    except Exception as exc:
        # corrupt .paramnames (bad encoding, binary junk): degrade like a
        # missing file — the H0 prior is skipped, the cell still computes
        logger.warning("unreadable .paramnames for %s: %s", root, exc)
        return None
    for i, n in enumerate(names):
        if n == "H0":
            return i
    return None


# ---------------------------------------------------------------------------
# grid discovery (reference planck_mcevidence.py:202-230)
# ---------------------------------------------------------------------------

def avail_data_list(rootdir: str, model: str):
    """All dataset chain roots available for a model."""
    hits = _glob.glob(f"{rootdir}/{model}/*/*_1.txt")
    roots = [x.split("_1.txt")[0] for x in hits]
    names = [os.path.basename(r).split(f"{model}_", 1)[-1] for r in roots]
    return roots, names


def avail_model_list(rootdir: str, dataset: str, nmax: int = 0,
                     sorter: Sequence[str] = MODELS):
    """All model chain roots available for a dataset, in canonical model
    order (reference sorts via a pandas categorical)."""
    hits = _glob.glob(f"{rootdir}/*/*/*_{dataset}_1.txt")
    roots = [x.split("_1.txt")[0] for x in hits]
    models = [r.split(os.sep)[-3] if len(r.split(os.sep)) >= 3 else ""
              for r in roots]
    order = {m: i for i, m in enumerate(sorter)}
    pairs = sorted(zip(roots, models),
                   key=lambda rm: order.get(rm[1], len(order)))
    if nmax > 0:
        pairs = pairs[:nmax]
    if not pairs:
        return [], []
    r, m = zip(*pairs)
    return list(r), list(m)


def work_split(num_shards: int, items: Sequence) -> List[List]:
    """Deterministic near-equal split (fixes the reference's remainder bug:
    planck_mcevidence.py:149-156 skipped/duplicated datasets, quirk Q10)."""
    return [list(items[i::num_shards]) for i in range(num_shards)]


# ---------------------------------------------------------------------------
# per-dataset evidence table
# ---------------------------------------------------------------------------

def _tabulate(df) -> str:
    try:
        from tabulate import tabulate
        return tabulate(df, headers="keys", tablefmt="psql", floatfmt=".2f",
                        numalign="left")
    except ImportError:
        return df.to_string(float_format=lambda x: f"{x:.2f}")


def _model_prologue(mm, fname, info, use_h0_prior, futures, chain_exts,
                    vol_norm):
    """Per-model prologue of the dataset walk (``_dataset_walk``):
    availability check, metadata with NaN degradation, base-volume
    normalization, stale-prefetch cancel, H0-column lookup.

    A corrupt or missing ``.ranges``/``log.param`` NaNs THIS model's row
    instead of aborting the dataset/shard: the reference's one graceful
    degradation (unavailable cells become NaN, planck_mcevidence.py:
    355-361) extended to metadata failures, on which it would crash.

    Returns (prior_volume, ndim, h0i, vol_norm), or None when this model is
    skipped (its info rows are already appended)."""
    par = None
    if not _glob.glob(fname + "*.txt"):
        logger.warning("*** not available: %s", fname)
    else:
        try:
            par = params_info(fname, cosmo=True)
        except Exception as exc:
            logger.warning("*** params_info failed for %s: %s", fname, exc)
            if mm == "base":
                logger.warning(
                    "base model metadata failed: PriorVol for the other "
                    "models is NOT normalized by the base volume "
                    "(reference convention, planck_mcevidence.py:329-331) "
                    "— absolute lnE values shift by ln(V_base)")
            for ext in chain_exts:     # don't parse/hold chains we'll skip
                fut = futures.pop(fname + ext, None)
                if fut is not None:
                    fut.cancel()
    if par is None:
        for key, val in (("N_read", ""), ("N_used", ""),
                         ("PriorVol", 0), ("ndim", 0)):
            info[key].append(val)
        return None
    if mm == "base":
        vol_norm = par.volume
    prior_volume = par.volume / vol_norm
    info["PriorVol"].append(prior_volume)
    info["ndim"].append(par.ndim)
    h0i = h0_index_for_chain(fname) if use_h0_prior else None
    return prior_volume, par.ndim, h0i, vol_norm


PARSE_COUNTS = ("parse_files", "parse_slices", "parse_fields",
                "parse_fields_fixed")


def _on_worker(load, path):
    """``load(path)`` on a prefetch thread: (its result or exception, the
    parse counts it made).  The dataset's collector belongs to the main
    thread, so the worker counts under its own and ``_take`` adds them."""
    counts: Dict = {}
    try:
        with collect(counts, []):
            out = load(path)
    except Exception as exc:
        out = exc
    return out, {k: counts[k] for k in PARSE_COUNTS if k in counts}


def _take(future):
    """A prefetch future's result; its parse counts go to the collector."""
    with span("grid_parse_wait"):
        out, counts = future.result()
    for name, n in counts.items():
        count(name, n)
    return out


def _dataset_walk(path_list, names, chain_exts, load, *, info,
                  use_h0_prior, parse_workers):
    """One dataset's models in order, each chain file loaded ahead by
    ``load(path)`` on prefetch threads.  Yields (imm, (prior_volume, ndim,
    h0i), chains) for each model ``_model_prologue`` keeps; the caller
    takes every (icc, path, loaded object or exception) of ``chains``
    before the next model, and appends the model's N_read and N_used."""
    pool = ThreadPoolExecutor(max_workers=max(1, parse_workers))
    futures = {fname + ext: pool.submit(_on_worker, load, fname + ext)
               for fname in path_list if _glob.glob(fname + "*.txt")
               for ext in chain_exts}
    try:
        vol_norm = 1.0
        for imm, (mm, fname) in enumerate(zip(names, path_list)):
            with span("grid_prologue"):
                pro = _model_prologue(mm, fname, info, use_h0_prior,
                                      futures, chain_exts, vol_norm)
            if pro is None:
                continue
            vol_norm = pro[3]
            # pop: keeping every parsed chain referenced until the end of
            # the dataset would hold multi-GB of float64 arrays alive
            yield imm, pro[:3], (
                (icc, fname + ext, _take(futures.pop(fname + ext)))
                for icc, ext in enumerate(chain_exts))
    finally:
        pool.shutdown(wait=False)


# a model x chain cell of the batched grid (sumw_adj: H0-reweighted SumW)
_Cell = namedtuple("_Cell", "imm icc ndim samples lnl weights samples2 "
                            "prior_volume sumw_adj")


def _dataset_cells_batched(path_list, names, chain_exts, *, kmax,
                           burnfrac, thinfrac, use_h0_prior, mce, info,
                           precision: str = "refine", cross: bool = False,
                           engine: str = "auto", seed=None,
                           parse_workers: int = 2, device="cuda"):
    """Fill the evidence matrix ``mce`` by batching cells on the card.

    ``precision='device'``: chunks of same-bucket cells go through one
    batched selection launch each (``sharded_grid_device_refine_evidence``)
    and the other cells one by one through the device path, every launch
    made before any result is fetched.  ``precision='refine'``: the cells of
    each row bucket go through ``sharded_grid_evidence_refine`` (batched
    selection, host f64 refinement).  ``precision='fast'``: the cells of
    each (ndim, row bucket) group go through ``sharded_grid_auto_evidence``
    (whitening, batched selection and estimator in f32 on the card);
    cross-evidence runs on the refine path.  ``cross=True`` splits each
    chain and runs cross-evidence.  Needs numpy and torch, not pandas.
    """
    from .chains.reader import ingest

    def load(path):
        # a fresh generator of ``seed`` for each file
        return ingest(path, burnlen=burnfrac, thinlen=thinfrac, split=cross,
                      rng=np.random.default_rng(seed))
    cells = []
    for imm, (prior_volume, ndim, h0i), chains in _dataset_walk(
            path_list, names, chain_exts, load, info=info,
            use_h0_prior=use_h0_prior, parse_workers=parse_workers):
        nc_read, nc_use = "", ""
        for icc, path, pair in chains:
            try:
                if isinstance(pair, Exception):
                    raise pair
                p = pair.s1
                s2 = pair.s2.samples[:, :ndim] if cross else None
                sumw_adj = None
                if h0i is not None:
                    # quirk Q7: importance reweighting enters only SumW
                    with span("grid_prologue"):
                        neg = make_h0_gauss_lnp(h0i)(p.samples)
                        sumw_adj = float(np.sum(p.weights * np.exp(-neg)))
                cells.append(_Cell(imm, icc, ndim, p.samples[:, :ndim],
                                   p.lnp(), p.weights, s2, prior_volume,
                                   sumw_adj))
                # same strings the per-cell mode takes from the info dict
                # (post-burn/thin s1 count; N_used lists every partition)
                nc_read += f"{p.nsamples},"
                parts = [p.nsamples] + ([pair.s2.nsamples] if cross else [])
                nc_use += ", ".join(str(x) for x in parts) + ","
            except Exception as exc:
                logger.warning("ingest failed for %s: %s", path, exc)
        info["N_read"].append(nc_read)
        info["N_used"].append(nc_use)
    count("grid_cells", len(cells))

    if cross and precision == "fast":
        logger.info("batched cross-evidence runs on the refine path")
        precision = "refine"

    # chains wider than the batched programs' widest class (--allparams on
    # a many-nuisance model) go one by one: at device through the
    # single-chain device path (which takes up to knn_hopper.D_MAX
    # columns), else through the host refine path
    from .parallel.ring import GRID_DPAD
    wide = [c for c in cells if c.ndim > GRID_DPAD]
    if wide:
        from .evidence import evidence_fn
        from .ops.pipeline import device_refine_evidence
        logger.info("%d cell(s) with ndim > %d run one by one on the %s "
                    "path", len(wide), GRID_DPAD,
                    "single-chain device" if precision == "device"
                    else "host refine")
        cells = [c for c in cells if c.ndim <= GRID_DPAD]
        for c in wide:
            one = dict(samples2=c.samples2, kmax=kmax,
                       prior_volume=c.prior_volume,
                       sum_adjusted_weights=c.sumw_adj, engine=engine,
                       device=device)
            with span("grid_launch"):
                if precision == "device":
                    row = device_refine_evidence(c.samples, c.lnl, c.weights,
                                                 **one)
                else:
                    row = evidence_fn(c.samples, c.lnl, weights=c.weights,
                                      precision="refine", **one)
            mce[c.imm, c.icc, :] = row

    kw = dict(kmax=kmax, cross=cross, engine=engine, device=device)
    if precision == "device":
        _device_cells(cells, mce, nchain=len(chain_exts), **kw)
    else:
        _grouped_cells(cells, mce, precision=precision, **kw)


def _device_cells(cells, mce, *, nchain, kmax, cross, engine, device):
    """Fill the cells' rows on the device path, every launch made before
    any result is fetched.  A lone cell's thin or non-finite first pass
    re-runs synchronously through ``device_refine_evidence``."""
    from .ops import pipeline
    from .ops.knn import bucket_size_pow2
    # LOCAL: under --distributed each process runs its own datasets on its
    # own card, as JAX's default mesh takes the process's local devices
    from .parallel.ring import (LOCAL, _dpad_class,
                                sharded_grid_device_refine_evidence)

    # Chunk quantum: how many same-bucket cells share one batched
    # selection launch.  Per-chain mode (N times the cells at 1/N the
    # rows) chunks by default; AllChains cells go one by one.  Override
    # with MCE_GRID_QUANTUM (1 = per-cell launches).
    q_env = os.environ.get("MCE_GRID_QUANTUM")
    quantum = int(q_env) if q_env else (4 if nchain > 1 else 1)
    groups: Dict[tuple, list] = {}
    lone = cells
    if quantum > 1 and len(cells) > 1:
        lone = []
        for c in cells:
            n_ref = len(c.samples2) if cross else len(c.lnl)
            if n_ref <= kmax:       # too short for the batched program
                lone.append(c)
                continue
            key = (bucket_size_pow2(len(c.lnl)), _dpad_class(c.ndim),
                   bucket_size_pow2(len(c.samples2)) if cross else 0)
            groups.setdefault(key, []).append(c)
    chunks = []
    for group in groups.values():
        # tail remainder, routed as the JAX driver routes it: when the
        # remainder is a minority of a chunk, its cells go one by one;
        # otherwise (or when the whole group is smaller than one chunk)
        # they form a shorter last chunk
        n_full, rem = divmod(len(group), quantum)
        if n_full and 0 < rem <= quantum // 2:
            lone.extend(group[n_full * quantum:])
            group = group[:n_full * quantum]
        for c0 in range(0, len(group), quantum):
            # the batch is the chunk's true cells: one card needs no
            # padding to a fixed batch
            chunk = group[c0:c0 + quantum]
            with span("grid_launch"):
                fin = sharded_grid_device_refine_evidence(
                    [(c.samples, c.lnl, c.weights) for c in chunk],
                    kmax=kmax, prior_volumes=[c.prior_volume for c in chunk],
                    sum_adjusted_weights=[
                        c.sumw_adj if c.sumw_adj is not None
                        else float(np.sum(c.weights)) for c in chunk],
                    chains2=[c.samples2 for c in chunk] if cross else None,
                    engine=engine, group=LOCAL, device=device, defer=True)
            chunks.append((chunk, fin))
    for chunk, fin in chunks:
        with span("grid_fetch"):
            out = fin()
        for c, lnz in zip(chunk, out):
            mce[c.imm, c.icc, :] = lnz
    passes = []
    for c in lone:
        with span("grid_launch"):
            flat, _, plan = pipeline.device_refine_launch(
                c.samples, c.lnl, c.weights, samples2=c.samples2, kmax=kmax,
                engine=engine, device=device)
        passes.append((c, flat, plan))
    for c, flat, plan in passes:
        with span("grid_fetch"):
            row = pipeline.device_refine_finish(
                flat.cpu().numpy(), plan, prior_volume=c.prior_volume,
                sum_adjusted_weights=c.sumw_adj)
        if isinstance(row, str):
            count("grid_reruns")
            with span("grid_rerun"):
                row = pipeline.device_refine_evidence(
                    c.samples, c.lnl, c.weights, samples2=c.samples2,
                    kmax=kmax, prior_volume=c.prior_volume,
                    sum_adjusted_weights=c.sumw_adj, pad_candidates=20,
                    engine=engine, device=device)
        mce[c.imm, c.icc, :] = row


def _grouped_cells(cells, mce, *, precision, kmax, cross, engine, device):
    """Fill the cells' rows by one batched call a group of similar lengths
    (a batch's short members leave little of it idle): a row bucket at
    refine (zero-padded columns make mixed ndim fine), an (ndim, row
    bucket) at fast, whose program whitens on the card."""
    from .ops.knn import bucket_size
    from .parallel.ring import (LOCAL, sharded_grid_auto_evidence,
                                sharded_grid_evidence_refine)
    by_group: Dict[tuple, list] = {}
    for c in cells:
        key = ((bucket_size(len(c.lnl)),) if precision == "refine"
               else (c.ndim, bucket_size(len(c.lnl))))
        by_group.setdefault(key, []).append(c)
    for group in by_group.values():
        chains = [(c.samples, c.lnl, c.weights) for c in group]
        pv = [c.prior_volume for c in group]
        with span("grid_launch"):
            if precision == "refine":
                out = sharded_grid_evidence_refine(
                    chains, kmax=kmax, prior_volumes=pv,
                    sum_adjusted_weights=[
                        c.sumw_adj if c.sumw_adj is not None
                        else float(np.sum(c.weights)) for c in group],
                    chains2=[c.samples2 for c in group] if cross else None,
                    engine=engine, group=LOCAL, device=device)
            else:
                shifts = [0.0 if c.sumw_adj is None
                          else float(np.log(c.sumw_adj)
                                     - np.log(np.sum(c.weights)))
                          for c in group]
                out = sharded_grid_auto_evidence(
                    chains, kmax=kmax, prior_volumes=pv,
                    sumw_log_shifts=shifts, engine=engine, group=LOCAL,
                    device=device)
        for c, lnz in zip(group, out):
            mce[c.imm, c.icc, :] = lnz


def dataset_evidence(rootdir: str, dataset: str, *, kmax: int = 2,
                     nchain: int = 0, nmodel: int = 0,
                     burnfrac: float = 0.0, thinfrac: float = 0.0,
                     use_h0_prior: bool = True, verbose: int = 1,
                     engine: str = "auto", precision: str = "refine",
                     batch_cells: bool = False, cross: bool = False,
                     seed=None, parse_workers: int = 2, device="cuda"):
    """Evidence for every available model of one dataset, as a pandas
    DataFrame (None when no cell could be computed).

    ``nchain=0``: AllChains mode (every ``_?.txt`` combined, one column);
    ``nchain=n``: per-chain mode over ``_1..n.txt`` with Mean/Err columns.
    Prior volumes are normalized by the base model's volume (reference
    planck_mcevidence.py:324-331).  Missing model cells become NaN rows.
    ``cross=True`` runs split/cross-evidence per cell (an extension; the
    reference grid driver is auto-only).  With ``kmax>2`` extra ``_k<k>``
    columns carry the higher-k estimates (the reference emits only k=1).
    ``device`` is where the selection (and in ``device`` precision the
    refinement and reduction) runs; ``"cuda"`` raises without a card.
    The stages run under a collector held for the dataset, which
    ``_stage_log`` reads once the table is built.
    """
    from .evidence import MCEvidence, check_precision
    from .ops.knn import resolve_engine
    from .utils.device import resolve_device
    check_precision(precision)
    resolve_engine(engine)
    resolve_device(device)

    with _dataset_stages(dataset):
        path_list, names = avail_model_list(rootdir, dataset, nmax=nmodel)
        if not path_list:
            logger.warning("no chains found for dataset %s under %s",
                           dataset, rootdir)
            return None

        if nchain == 0:
            cols = ["AllChains"]
            chain_exts = [""]
        else:
            cols = [f"chain{i}" for i in range(1, nchain + 1)]
            chain_exts = [f"_{i}.txt" for i in range(1, nchain + 1)]

        mce = np.full((len(path_list), len(cols), kmax - 1), np.nan)
        info: Dict[str, list] = {k: [] for k in INFO_COLS}

        if batch_cells:
            _dataset_cells_batched(
                path_list, names, chain_exts, kmax=kmax, burnfrac=burnfrac,
                thinfrac=thinfrac, use_h0_prior=use_h0_prior, mce=mce,
                info=info, precision=precision, cross=cross, engine=engine,
                seed=seed, parse_workers=parse_workers, device=device)
        else:
            from .chains.reader import load_chains
            for imm, (prior_volume, ndim, h0i), chains in _dataset_walk(
                    path_list, names, chain_exts, load_chains, info=info,
                    use_h0_prior=use_h0_prior, parse_workers=parse_workers):
                isfunc = make_h0_gauss_lnp(h0i) if h0i is not None else None
                nc_read, nc_use = "", ""
                for icc, fchain, chain in chains:
                    try:
                        if isinstance(chain, Exception):
                            raise chain     # a missing chain: a NaN cell
                        count("grid_cells")
                        with span("grid_launch"):
                            e, einfo = MCEvidence(
                                chain, ndim=ndim, isfunc=isfunc,
                                priorvolume=prior_volume, kmax=kmax,
                                verbose=verbose, burnlen=burnfrac,
                                thinlen=thinfrac, split=cross, seed=seed,
                                engine=engine, precision=precision,
                                device=device,
                            ).evidence(info=True, pos_lnp=False)
                        mce[imm, icc, :] = e
                        nc_read += f"{einfo['Nsamples_read']},"
                        nc_use += f"{einfo['Nsamples']},"
                    except Exception as exc:
                        logger.warning("evidence failed for %s: %s", fchain,
                                       exc)
                info["N_read"].append(nc_read)
                info["N_used"].append(nc_use)

        if np.all(np.isnan(mce)):
            return None
        return _build_dataset_frame(mce, names, cols, nchain, info)


@contextmanager
def _dataset_stages(dataset):
    """A collector for one dataset's stages; logs them when it closes."""
    timings: Dict = {}
    with collect(timings, []):
        yield
    _stage_log(dataset, timings)


def _stage_log(dataset, timings):
    """Log a dataset's stage seconds (``STAGES``, summed by their spans)
    and its counts, as one record whose ``args`` is that dict."""
    stages = {f"{s}_s": timings.get(f"{s}_s", 0.0) for s in STAGES}
    stages.update(dataset=dataset, cells=timings.get("grid_cells", 0),
                  reruns=timings.get("grid_reruns", 0))
    logger.info(
        "dataset stages of %(dataset)s: parse-wait %(grid_parse_wait_s).2fs,"
        " prologue %(grid_prologue_s).2fs, launch %(grid_launch_s).2fs, "
        "fetch %(grid_fetch_s).2fs, re-run %(grid_rerun_s).2fs (%(reruns)d "
        "of %(cells)d cells), frame %(grid_tables_s).2fs", stages)


def _build_dataset_frame(mce, names, cols, nchain, info):
    """Per-dataset table: Mean/Err/delta columns + info columns
    (reference planck_mcevidence.py:363-375).

    ``mce`` is (models, chains, kmax-1); the reference's table layout uses
    k=1 only, so for kmax>2 the higher-k estimates go into extra
    ``<col>_k<k>`` columns appended before the info block (instead of being
    silently dropped)."""
    with span("grid_tables"):
        import pandas as pd
        df = pd.DataFrame(mce[:, :, 0], index=names, columns=cols)
        df_mean = df.mean(axis=1)
        if nchain > 0:
            df["Mean_lnE_k1"] = df_mean
            df["Err_lnE_k1"] = (df.loc[:, cols].std(axis=1)
                                / np.sqrt(float(nchain)))
        df["delta_lnE_k1"] = df_mean - df_mean.max()
        for k in range(2, mce.shape[2] + 1):
            for j, col in enumerate(cols):
                df[f"{col}_k{k}"] = mce[:, j, k - 1]
        for k in INFO_COLS:
            df[k] = info[k]
    return df


# ---------------------------------------------------------------------------
# grid run + aggregation (reference planck_mcevidence.py:263-484)
# ---------------------------------------------------------------------------

def run_grid(rootdir: str, outdir: str, *, basename: str = "mce",
             datasets: Optional[Sequence[str]] = None, kmax: int = 2,
             nchain: int = 0, ndata: int = 0, nmodel: int = 0,
             burnfrac: float = 0.0, thinfrac: float = 0.0,
             use_h0_prior: bool = True, verbose: int = 1,
             num_shards: int = 1, shard_id: int = 0,
             engine: str = "auto", precision: str = "refine",
             batch_cells: bool = False, cross: bool = False, seed=None,
             resume: bool = False, device="cuda") -> Dict:
    """Run the evidence grid for this shard's datasets; write per-dataset
    txt/csv.  Returns {dataset: delta_lnE series}.

    ``resume=True`` skips datasets whose per-dataset csv already exists —
    a crashed run keeps its completed datasets (the reference's incremental
    per-dataset outputs, planck_mcevidence.py:387-404, made explicit).
    """
    import pandas as pd
    data_list = list(datasets if datasets is not None else DATASETS)
    if ndata > 0:
        data_list = data_list[:ndata]
    if num_shards < 1 or not (0 <= shard_id < num_shards):
        # out-of-range used to die with a bare IndexError; a NEGATIVE id
        # silently wrapped, double-computing one shard and leaving another
        # uncomputed (the last-shard aggregation gate then waits forever)
        raise ValueError(
            f"invalid shard config: need 0 <= shard-id ({shard_id}) < "
            f"num-shards ({num_shards}) and num-shards >= 1")
    my_data = work_split(num_shards, data_list)[shard_id]

    mode_dir = "AllChains" if nchain == 0 else "SingleChains"
    out = os.path.join(outdir, mode_dir)
    out_csv = os.path.join(out, "csv")
    os.makedirs(out_csv, exist_ok=True)

    all_df: Dict = {}
    for dataset in my_data:
        fcsv = os.path.join(out_csv, f"{basename}_{dataset}.csv")
        if resume and os.path.exists(fcsv):
            logger.info("resume: skipping completed dataset %s", dataset)
            df = pd.read_csv(fcsv, index_col=0)
            if "delta_lnE_k1" in df:
                all_df[dataset] = df["delta_lnE_k1"]
            continue
        logger.info("--------------- %s ---------", dataset)
        df = dataset_evidence(
            rootdir, dataset, kmax=kmax, nchain=nchain, nmodel=nmodel,
            burnfrac=burnfrac, thinfrac=thinfrac,
            use_h0_prior=use_h0_prior, verbose=verbose,
            engine=engine, precision=precision, batch_cells=batch_cells,
            cross=cross, seed=seed, device=device)
        if df is None:
            continue
        all_df[dataset] = df["delta_lnE_k1"]
        with span("grid_tables"):
            if verbose > 0:
                print(_tabulate(df))
            with open(os.path.join(out, f"{basename}_{dataset}.txt"),
                      "w") as fh:
                fh.write(f"\n************ {dataset} ************\n")
                fh.write(_tabulate(df))
                fh.write("\n")
            df.to_csv(os.path.join(out_csv, f"{basename}_{dataset}.csv"))
    return all_df


def aggregate(outdir: str, *, basename: str = "mce", nchain: int = 0,
              rootdir: str = DEFAULT_ROOTDIR,
              datasets: Sequence[str] = DATASETS,
              model_list: Sequence[str] = MODELS,
              all_df: Optional[Dict] = None) -> None:
    """Merge per-dataset outputs into the grid-level artifacts
    (reference planck_mcevidence.py:417-484): concatenated txt, delta-lnE
    pickles, and the model x dataset table with a C0.. column legend."""
    import pandas as pd
    mode_dir = "AllChains" if nchain == 0 else "SingleChains"
    out = os.path.join(outdir, mode_dir)
    out_csv = os.path.join(out, "csv")

    # concat per-dataset txt shards (kept on disk, unlike the reference,
    # so shard reruns stay incremental)
    fmain = os.path.join(out, f"{basename}_planck_fullgrid.txt")
    with open(fmain, "w") as outfile:
        outfile.write(f"\n############## RootDirectory={rootdir} ########\n")
        for dataset in datasets:
            fin = os.path.join(out, f"{basename}_{dataset}.txt")
            if os.path.exists(fin):
                with open(fin) as fh:
                    outfile.write(fh.read())
    logger.info("wrote %s", fmain)

    if all_df is None:
        # recover the delta columns from the per-dataset csv shards
        all_df = {}
        for dataset in datasets:
            fcsv = os.path.join(out_csv, f"{basename}_{dataset}.csv")
            if os.path.exists(fcsv):
                df = pd.read_csv(fcsv, index_col=0)
                if "delta_lnE_k1" in df:
                    all_df[dataset] = df["delta_lnE_k1"]
    if not all_df:
        logger.warning("nothing to aggregate under %s", out)
        return

    with open(os.path.join(out_csv, "delta_lnE_all_dict.pkl"), "wb") as fh:
        pickle.dump(all_df, fh)
    big = pd.DataFrame(index=list(model_list))
    for dd, series in all_df.items():
        big[dd] = series
    # column order follows the canonical dataset list
    ordered = [d for d in datasets if d in big.columns]
    big = big[ordered]
    with open(os.path.join(out_csv, "delta_lnE_all_df.pkl"), "wb") as fh:
        pickle.dump(big, fh)

    fout = os.path.join(out, "delta_lnE_all.txt")
    with open(fout, "w") as fh:
        fh.write(f"\n############## RootDirectory={rootdir} ########\n\n")
        short = []
        for ik, k in enumerate(big.columns):
            fh.write(f"# C{ik}={k} \n")
            short.append(f"C{ik}")
        legend = big.copy()
        legend.columns = short
        fh.write(_tabulate(legend))
        fh.write("\n")
    logger.info("wrote %s", fout)


# ---------------------------------------------------------------------------
# CLI (reference planck_mcevidence.py:65-129)
# ---------------------------------------------------------------------------

def build_parser() -> ArgumentParser:
    from .ops.knn import ENGINE_HELP, ENGINES
    p = ArgumentParser(prog="mcevidence-planck",
                       description="Planck full-grid MCEvidence "
                                   "(PyTorch/CUDA)")
    p.add_argument("-k", "--kmax", default=2, type=int)
    p.add_argument("-nc", "--nchain", default=0, type=int,
                   help="0: AllChains mode; n>0: per-chain mode over _1..n")
    p.add_argument("-nd", "--ndata", default=0, type=int,
                   help="use only the first n datasets")
    p.add_argument("-nm", "--nmodel", default=0, type=int,
                   help="use only the first n models per dataset")
    p.add_argument("-b", "--burnfrac", "--burnin", "--remove",
                   dest="burnfrac", default=0, type=float)
    p.add_argument("-t", "--thin", "--thinfrac", dest="thinfrac",
                   default=0, type=float,
                   help="thinning: 0<t<1 Poisson, t>1 getdist weighted, "
                        "t<0 autocorrelation-length x |t| (quirk Q9: the "
                        "reference documented t<0 but never implemented it)")
    p.add_argument("-o", "--out", "--outdir", dest="outdir",
                   default="planck_mce_fullGrid_R2_H0Reiss2016")
    p.add_argument("--N", "--name", dest="name", default="mce")
    p.add_argument("-v", "--verbose", default=1, type=int)
    p.add_argument("--rootdir", default=DEFAULT_ROOTDIR,
                   help="Planck full-grid chain directory")
    p.add_argument("--no-h0-prior", action="store_true",
                   help="disable the Riess-2016 H0 importance prior")
    p.add_argument("--num-shards", default=1, type=int,
                   help="split the dataset list over this many driver "
                        "processes (multi-host fan-out)")
    p.add_argument("--shard-id", default=0, type=int)
    p.add_argument("--procs", default=1, type=int,
                   help="single-command fan-out: fork this many shard "
                        "processes and auto-aggregate when all finish (the "
                        "reference's 'mpirun -np N' UX, "
                        "planck_mcevidence.py:27-29)")
    p.add_argument("--aggregate-only", action="store_true",
                   help="only merge existing per-dataset outputs")
    p.add_argument("--no-aggregate", action="store_true",
                   help="never merge (shard workers forked by --procs)")
    p.add_argument("--resume", action="store_true",
                   help="skip datasets whose csv output already exists")
    p.add_argument("--parse-cache", default="", metavar="DIR",
                   help="cache raw parsed chain tables as .npy under DIR "
                        "(keyed on path+size+mtime; burn/thin/split run "
                        "downstream, so settings changes reuse the cache)")
    from argparse import BooleanOptionalAction
    p.add_argument("--batch-cells", action=BooleanOptionalAction,
                   default=True,
                   help="batch a dataset's cells into batched selection "
                        "launches (the default; --no-batch-cells runs cells "
                        "one by one through MCEvidence)")
    p.add_argument("--cross", action="store_true",
                   help="split/cross-evidence per cell (an extension; the "
                        "reference grid driver is auto-only)")
    p.add_argument("--seed", default=None, type=int,
                   help="RNG seed for the cross-evidence split")
    p.add_argument("--engine", default="auto", choices=list(ENGINES),
                   help=ENGINE_HELP)
    p.add_argument("--device", default="cuda",
                   help="where the selection (and in device precision the "
                        "refinement and reduction) runs: 'cuda' (default; "
                        "fails without a GPU) or 'cpu'")
    p.add_argument("--precision", default="device",
                   choices=["device", "refine", "fast"],
                   help="device: f64 refinement and reduction on --device, "
                        "scalars-only fetch (the default); refine: host f64 "
                        "candidate refinement; fast: whitening, selection "
                        "and estimator in f32 on --device (~1e-3 in ln Z)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed job of torchrun's "
                        "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT) over gloo: one dataset "
                        "shard a rank (unless --num-shards/--shard-id say "
                        "otherwise), --device cuda on cuda:LOCAL_RANK, the "
                        "last shard merging once every rank is done")
    return p


def _expected_csvs(outdir, basename, nchain, datasets, rootdir) -> List[str]:
    """Per-dataset csv paths a complete run must have produced: one for
    every dataset that is actually discoverable under the chain rootdir."""
    mode_dir = "AllChains" if nchain == 0 else "SingleChains"
    out_csv = os.path.join(outdir, mode_dir, "csv")
    return [os.path.join(out_csv, f"{basename}_{d}.csv") for d in datasets
            if _glob.glob(f"{rootdir}/*/*/*_{d}_1.txt")]


def _launch_procs(argv, procs: int) -> int:
    """Fork ``procs`` shard workers with the same flags, wait, aggregate.

    The single-command replacement for the reference's
    ``mpirun -np N python planck_mcevidence.py`` launch."""
    import subprocess
    raw = list(sys.argv[1:] if argv is None else argv)
    # strip --procs so workers don't recurse
    base = []
    skip = False
    for a in raw:
        if skip:
            skip = False
            continue
        if a == "--procs":
            skip = True
            continue
        if a.startswith("--procs="):
            continue
        base.append(a)
    workers = []
    for sid in range(procs):
        cmd = [sys.executable, "-m", "mcevidence_tpu_torch.planck", *base,
               "--num-shards", str(procs), "--shard-id", str(sid),
               "--no-aggregate"]
        workers.append(subprocess.Popen(cmd))
    rc = 0
    for w in workers:
        rc = max(rc, w.wait())
    if rc != 0:
        logger.error("a shard worker failed (rc=%d); aggregating anyway "
                     "so completed datasets are merged", rc)
    agg = main([*base, "--aggregate-only"])
    return max(rc, agg)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.kmax < 2:
        # a bare assert is stripped under python -O, after which kmax=1
        # builds a zero-width evidence matrix and the whole run silently
        # computes nothing
        raise SystemExit("error: -k/--kmax must be >= 2")
    if args.distributed:
        _init_distributed(args)
        try:
            return _main(args, argv)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    return _main(args, argv)


def _init_distributed(args) -> None:
    """Join torchrun's job (``jax.distributed.initialize`` in JAX): one
    dataset shard a rank unless the shards were given explicitly, and the
    rank's own card.  The group carries no tensor, only the barrier before
    the merge, so it runs over gloo wherever the ranks are."""
    import datetime

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=1800))
    if args.num_shards == 1:
        args.num_shards = dist.get_world_size()
        args.shard_id = dist.get_rank()
    if args.device == "cuda":
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    logger.info("distributed: rank %d/%d takes dataset shard %d of %d on %s",
                dist.get_rank(), dist.get_world_size(), args.shard_id,
                args.num_shards, args.device)


def _main(args, argv) -> int:
    if not args.aggregate_only:
        # merging outputs needs no device
        from .evidence import check_precision
        from .ops.knn import resolve_engine
        from .utils.device import resolve_device
        try:
            check_precision(args.precision)
            resolve_engine(args.engine)
            resolve_device(args.device)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.procs > 1:
        return _launch_procs(argv, args.procs)
    configure(args.verbose)
    if args.verbose > 0:
        print(args)

    if args.parse_cache:
        from .chains.reader import set_parse_cache
        set_parse_cache(args.parse_cache)
    all_df = None
    if not args.aggregate_only:
        all_df = run_grid(
            args.rootdir, args.outdir, basename=args.name,
            kmax=args.kmax, nchain=args.nchain, ndata=args.ndata,
            nmodel=args.nmodel, burnfrac=args.burnfrac,
            thinfrac=args.thinfrac, use_h0_prior=not args.no_h0_prior,
            verbose=args.verbose, num_shards=args.num_shards,
            shard_id=args.shard_id, engine=args.engine,
            precision=args.precision, batch_cells=args.batch_cells,
            cross=args.cross, seed=args.seed, resume=args.resume,
            device=args.device)
    if args.distributed:
        # every rank's datasets are on disk before the last shard merges
        import torch.distributed as dist
        dist.barrier()
    if args.no_aggregate:
        return 0
    # last shard (or a dedicated --aggregate-only run) merges everything
    if args.aggregate_only or args.num_shards == 1 \
            or args.shard_id == args.num_shards - 1:
        datasets = DATASETS[:args.ndata] if args.ndata > 0 else DATASETS
        if args.num_shards > 1 and not args.aggregate_only:
            # other shard processes may still be running: only merge when
            # every expected per-dataset csv is already on disk (a partial
            # merge would silently drop datasets from the grid artifacts)
            missing = [f for f in _expected_csvs(args.outdir, args.name,
                                                 args.nchain, datasets,
                                                 args.rootdir)
                       if not os.path.exists(f)]
            if missing:
                logger.warning(
                    "not aggregating: %d per-dataset csv(s) still missing "
                    "(other shards running?). Run with --aggregate-only "
                    "once all shards finish. Missing: %s",
                    len(missing), ", ".join(missing))
                return 3
        with span("grid_tables"):
            aggregate(args.outdir, basename=args.name, nchain=args.nchain,
                      rootdir=args.rootdir, datasets=datasets,
                      all_df=all_df if args.num_shards == 1 else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
