"""Evidence over many processes: the ring kNN, and many chains in one batch.

The counterpart of ``mcevidence_tpu/parallel/ring.py``.  Its O(N^2 d) sweep
is shaped like ring attention: each rank keeps a shard of the query rows,
the reference shards go round a ring of ranks (``isend``/``irecv`` to rank
(p + 1) mod P, the counterpart of ``lax.ppermute``), and every rank merges
each visiting shard's selection into a running top-k by (d2, global row
id).  Whitening moments and the estimator's reduction are ``all_reduce``s
(the counterparts of ``psum``/``pmax``).  Every selection runs on the
rank's card through the port's kernels (``ops/knn.py:selector``).

Calling convention (SPMD): every rank calls a ``sharded_*`` function with
the full host arrays, as JAX's take full arrays, and every rank gets the
result.  ``group`` names the ranks: None is the default process group (the
counterpart of ``mesh=None`` and ``_default_mesh``), or this process alone
when none is initialized; ``LOCAL`` is this process alone (the grid
driver's per-dataset programs under ``--distributed``); a
``torch.distributed`` group, or a ``Ring``.  The grid programs take
``dp``, the counterpart of the ``dp`` axis of a dp x ring mesh: the group's
ranks form ``dp`` rings of equal size (``grid_layout``, built with
``torch.distributed.new_group``), each ring takes its share of the chains,
and each chain's rows go round its ring.

Transport: the group's backend.  NCCL moves card tensors and needs one card
a rank; gloo moves host copies of the shards, so ranks may share a card (the
selections still run on it).  Nothing falls back to computing on the host.
``device`` is the rank's card: ``"cuda"`` means ``cuda:LOCAL_RANK`` once a
group is initialized; ``"cpu"`` runs the kernels' plain versions.

Precisions, as in the JAX package:
* ``fast``: f32 on the card: masked f64 moments all-reduced, f32 whitening,
  the ring selection of kmax neighbours and the all-reduced log-space
  reduction (~1e-3 in ln Z).
* ``refine``: host f64 whitening, the ring selection of kmax + pad
  candidates in f32 (centred once over the chain in f64, so every shard
  sees the same f32 coordinates), the candidates' global indices gathered
  to every rank, host f64 refinement with the sufficiency guard (whose
  reselect goes round the ring again) and the host f64 estimator.
* ``device``: query rows sharded, the reference on every rank; each rank
  runs the fused device pipeline (``ops/pipeline.py:fused_refine_dotp``)
  on its shard at its global row offset, and the partial sums are
  gathered and combined in host f64.

With one rank, the grid programs are the one-card batched programs: one
batched selection launch over a whole batch of chains, with each member's
true row counts as runtime values (no compile buckets, no padded batch).
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.estimator import (log_ball_volume_const, log_evidence_from_knn,
                             log_evidence_from_knn_np)
from ..ops.knn import center_f64, guarded_refine_knn_f64, selector
from ..ops.knn_hopper import D_MAX
from ..ops.pipeline import (NONFINITE, THIN, _device_refine_prepare,
                            device_refine_finish, fused_refine_dotp,
                            fused_refine_dotp_batch, host_refine_evidence)
from ..ops.whiten import (_whiten_from_cov, apply_whiten, whiten_masked,
                          whiten_stats)
from ..utils.device import resolve_device
from .launch import check_backend

logger = logging.getLogger(__name__)

# group=LOCAL: this process alone, with no collectives
LOCAL = "local"


# ---------------------------------------------------------------------------
# the group layout (the counterpart of Mesh and _mesh_key)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ring:
    """A 1-D ring of ranks: its process group (None: the default group),
    the global ranks in ring order, this rank's place on it, and the
    transport (the group's backend; None for a process alone)."""

    group: object
    ranks: Tuple[int, ...]
    rank: int
    backend: Optional[str]

    @property
    def size(self) -> int:
        return len(self.ranks)


_ALONE = Ring(None, (0,), 0, None)


def ring_group(group=None) -> Ring:
    """The ``Ring`` of ``group`` (see the module docstring)."""
    if isinstance(group, Ring):
        return group
    if (isinstance(group, str) and group == LOCAL) or (
            group is None and not dist.is_initialized()):
        return _ALONE
    ranks = tuple(range(dist.get_world_size()) if group is None
                  else dist.get_process_group_ranks(group))
    return Ring(group, ranks, ranks.index(dist.get_rank()),
                str(dist.get_backend(group)))


@dataclass(frozen=True)
class GridLayout:
    """A dp x ring layout: ``dp`` rings of equal size over a group's ranks
    (ring i holds the group's ranks i * size .. (i + 1) * size - 1); this
    rank's ring and its index, and the whole group (``world``)."""

    dp: int
    dp_index: int
    ring: Ring
    world: Ring


# the rings of each (ranks, dp, backend): every rank creates every ring's
# group once, in the same order, as torch.distributed.new_group requires
_RING_GROUPS: dict = {}


def grid_layout(dp: int = 1, group=None) -> GridLayout:
    """The dp x ring layout of ``group``'s ranks (the counterpart of a 2-D
    ("dp", "ring") mesh); every rank of the group must call it."""
    world = ring_group(group)
    if dp < 1 or world.size % dp:
        raise ValueError(f"dp={dp} does not divide the {world.size} ranks")
    if dp == 1:
        return GridLayout(1, 0, world, world)
    n = world.size // dp
    key = (world.ranks, dp, world.backend)
    groups = _RING_GROUPS.get(key)
    if groups is None:
        groups = [dist.new_group(list(world.ranks[i * n:(i + 1) * n]),
                                 backend=world.backend) for i in range(dp)]
        _RING_GROUPS[key] = groups
    i = world.rank // n
    return GridLayout(dp, i, Ring(groups[i], world.ranks[i * n:(i + 1) * n],
                                  world.rank - i * n, world.backend), world)


def rank_device(device="cuda") -> torch.device:
    """The rank's device: ``"cuda"`` without an index is ``cuda:LOCAL_RANK``
    once a process group is initialized."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(dev)


def _check_transport(ring: Ring, dev: torch.device) -> None:
    """NCCL takes one card a rank: raise (naming gloo) where the host's
    ranks outnumber its cards or a rank is on the host; else make the
    rank's card current, where NCCL places its communicators."""
    if ring.backend != "nccl":
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE", ring.size))
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    check_backend("nccl", [dev] if dev.type != "cuda" else
                  [torch.device("cuda", i % max(cards, 1))
                   for i in range(local)])
    torch.cuda.set_device(dev)


# ---------------------------------------------------------------------------
# collectives on the ring's transport
# ---------------------------------------------------------------------------

def _wire(ring: Ring, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the transport carries it: a host copy under gloo."""
    if ring.backend == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t.contiguous()


def _all_reduce(ring: Ring, t: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    if ring.size == 1:
        return t
    x = _wire(ring, t).clone()
    dist.all_reduce(x, op=op, group=ring.group)
    return x.to(t.device)


def _all_gather(ring: Ring, t: torch.Tensor) -> torch.Tensor:
    """(P, ...) stack of every rank's ``t`` (same shape on every rank)."""
    if ring.size == 1:
        return t[None]
    x = _wire(ring, t)
    out = [torch.empty_like(x) for _ in range(ring.size)]
    dist.all_gather(out, x, group=ring.group)
    return torch.stack(out).to(t.device)


def _start_shift(ring: Ring, t: torch.Tensor):
    """Send ``t`` to the next rank of the ring and receive the previous
    rank's, without waiting (``lax.ppermute`` with i -> i + 1)."""
    x = _wire(ring, t)
    out = torch.empty_like(x)
    nxt = ring.ranks[(ring.rank + 1) % ring.size]
    prv = ring.ranks[(ring.rank - 1) % ring.size]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, nxt, ring.group),
        dist.P2POp(dist.irecv, out, prv, ring.group)])
    return reqs, x, out


def _finish_shift(pending, dev: torch.device) -> torch.Tensor:
    reqs, _, out = pending
    for req in reqs:
        req.wait()
    return out.to(dev)


# ---------------------------------------------------------------------------
# per-rank bodies
# ---------------------------------------------------------------------------

_ABSENT = torch.iinfo(torch.int64).max


def _merge_keys(d2: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """int64 keys of candidates: the f32 bits of d2 (>= 0, so they order as
    the floats) above the global row id, absent slots last.  The same
    total order as the kernels' keys, so merging hops selects what one
    selection over all rows would."""
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(gidx < 0, _ABSENT, (bits << 32) | gidx)


def _ring_knn_local(q, r, k, ring: Ring, n_ref, self_mode, select, *,
                    batched, n_query=None):
    """The per-rank body of the ring kNN (``_ring_knn_local`` in JAX).

    ``q`` (B, Nq_loc, d): this rank's query shard of B chains; ``r`` (B,
    Nr_loc, d): its reference shard; both f32 on the rank's device and
    centred for their whole chains.  Global rows are shard-major: rank p
    holds rows p * loc .. (p + 1) * loc - 1.  ``n_ref`` (B ints): the true
    reference rows (rows past them are padding, never selected);
    ``n_query`` the true query rows (default: ``n_ref`` in self mode, else
    every row).  ``select``: a selection of ``ops/knn.py:selector``,
    batched (B, N, d) when ``batched``, else 2-D with B = 1; it takes the
    rows uncentred (``center=False``), so each pair's d2 is the same
    whichever shard holds it.  Self mode: shard p of the queries is shard p of the reference; the
    kernel pins a query's own row to slot 0 at the diagonal hop only, and
    the merge keeps it first.  Returns (d2, idx) (B, Nq_loc, min(k, Nr_loc
    P)) with global int32 row ids."""
    nb, nq_loc, _ = q.shape
    nr_loc = r.shape[1]
    size, p = ring.size, ring.rank
    k = min(k, nr_loc * size)
    dev = q.device
    run_d2 = torch.full((nb, nq_loc, k), math.inf, dtype=torch.float32,
                        device=dev)
    run_idx = torch.full((nb, nq_loc, k), -1, dtype=torch.int64, device=dev)
    own = (p * nq_loc + torch.arange(nq_loc, device=dev))[None, :, None]
    if n_query is None:
        n_query = n_ref if self_mode else [nq_loc * size] * nb
    nq_hop = [min(max(n - p * nq_loc, 0), nq_loc) for n in n_query]
    buf = r
    for step in range(size):
        # the shard visiting at this step started on rank (p - step) mod P
        src = (p - step) % size
        pending = _start_shift(ring, buf) if step + 1 < size else None
        nr_hop = [min(max(n - src * nr_loc, 0), nr_loc) for n in n_ref]
        kk = min(k, nr_loc)
        if max(nr_hop) > 0 and max(nq_hop) > 0:
            hop_self = self_mode and src == p
            if batched:
                d2, idx = select(q, buf, kk, self_mode=hop_self, nr=nr_hop,
                                 nq=nq_hop, center=False)
            else:
                d2, idx = select(q[0], buf[0], kk, self_mode=hop_self,
                                 nr=nr_hop[0], center=False)
                d2, idx = d2[None], idx[None]
            gidx = torch.where(idx >= 0, idx.long() + src * nr_loc, -1)
            d2c = torch.cat([run_d2, d2.float()], dim=2)
            ic = torch.cat([run_idx, gidx], dim=2)
            key = _merge_keys(d2c, ic)
            if self_mode:
                key = torch.where(ic == own, -1, key)
            _, pos = torch.topk(key, k, dim=2, largest=False, sorted=True)
            run_d2 = torch.gather(d2c, 2, pos)
            run_idx = torch.gather(ic, 2, pos)
        if pending is not None:
            buf = _finish_shift(pending, dev)
    return run_d2.clamp(min=0.0), run_idx.to(torch.int32)


def _moments(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[n, sum x, sum x x^T] of the valid rows in f64, packed (B, 1+d+d^2)."""
    x = s.double()
    w = valid.double()[..., None]
    sw = x * w
    return torch.cat([w.sum(dim=-2), sw.sum(dim=-2),
                      (sw.transpose(-1, -2) @ x).flatten(-2)], dim=-1)


def _cov_from_moments(m: torch.Tensor, d: int) -> torch.Tensor:
    n = m[..., :1]
    mean = m[..., 1:1 + d] / n
    sxx = m[..., 1 + d:].unflatten(-1, (d, d))
    return ((sxx - n[..., None] * mean[..., :, None] * mean[..., None, :])
            / (n[..., None] - 1.0))


def _whiten_local(s, valid, ring: Ring):
    """Whitening from moments summed over the ring (``_whiten_local``):
    the f64 moments of ``ops/whiten.py:whiten_masked``, all-reduced, then
    its eigh and rotation.  Returns (white, log_jacobian, posdef)."""
    m = _all_reduce(ring, _moments(s, valid))
    return _whiten_from_cov(s, _cov_from_moments(m, s.shape[-1]).to(s.dtype))


def _reduce_mle(d2, lnlike, weights, valid, log_j, *, kmax, n_global, ndim,
                log_prior_volume, k_start, ring: Ring):
    """The estimator's log-space reduction over the ring (``_reduce_mle``,
    ``ops/estimator.py`` semantics with all-reduce SUM/MAX): ``d2`` (B,
    n_loc, kmax) squared distances, ``lnlike``/``weights``/``valid`` (B,
    n_loc), ``log_j``, ``n_global`` and ``log_prior_volume`` (B,).  Returns
    (B, kmax) MLE rows, columns below ``k_start`` 0."""
    lnl_max = _all_reduce(
        ring, torch.where(valid > 0, lnlike, -math.inf).amax(dim=-1),
        dist.ReduceOp.MAX)
    fs = lnlike - lnl_max[..., None]
    pos = d2 > 0
    log_d = torch.where(pos, torch.log(torch.where(pos, d2, 1.0)), -math.inf)
    log_terms = (log_ball_volume_const(ndim) + 0.5 * ndim * log_d
                 + (fs - torch.log(weights))[..., None])
    log_terms = torch.where(valid[..., None] > 0, log_terms, -math.inf)
    m = _all_reduce(ring, log_terms.amax(dim=-2), dist.ReduceOp.MAX)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    sums = _all_reduce(ring, torch.exp(log_terms - m_safe[..., None, :])
                       .sum(dim=-2))
    sum_w = _all_reduce(ring, (weights * valid).sum(dim=-1))
    k_idx = torch.arange(kmax, device=d2.device)
    k_nn = (k_idx if k_start == 1 else k_idx + 1).to(d2.dtype)
    # S*k+1 in floating point: an int32 product overflows for huge chains
    log_amax = m_safe + torch.log(sums) - torch.log(
        n_global[..., None] * k_nn + 1.0)
    mle = (torch.log(sum_w)[..., None] + log_amax + log_j[..., None]
           + lnl_max[..., None] - log_prior_volume[..., None])
    return torch.where(k_idx < k_start, torch.zeros_like(mle), mle)


def _pad_columns(d2: torch.Tensor, kmax: int) -> torch.Tensor:
    """+inf columns up to kmax (a ring with fewer rows than kmax)."""
    if d2.shape[-1] >= kmax:
        return d2
    pad = d2.new_full(d2.shape[:-1] + (kmax - d2.shape[-1],), math.inf)
    return torch.cat([d2, pad], dim=-1)


def _evidence_step_local(samples, lnlike, weights, valid, n_global,
                         log_prior_volume, *, kmax: int, ndim: int,
                         ring: Ring, select, batched: bool):
    """Auto evidence of B chains' shards (``_evidence_step_local``):
    ``samples`` (B, n_loc, d) f32, centred; ``n_global`` B ints; returns
    the (B, kmax) MLE rows (column 0 unused)."""
    white, log_j, _ = _whiten_local(samples, valid, ring)
    d2, _ = _ring_knn_local(white, white, kmax, ring, n_global, True, select,
                            batched=batched)
    ng = torch.tensor(n_global, dtype=samples.dtype, device=samples.device)
    return _reduce_mle(_pad_columns(d2, kmax), lnlike, weights, valid, log_j,
                       kmax=kmax, n_global=ng, ndim=ndim,
                       log_prior_volume=log_prior_volume, k_start=1,
                       ring=ring)


def _cross_evidence_step_local(s1, lnl1, w1, valid1, s2, valid2, n1_global,
                               n2_global, log_prior_volume, *, kmax: int,
                               ndim: int, ring: Ring, select):
    """Cross evidence (``_cross_evidence_step_local``): neighbours of the
    s1 shards searched in the visiting s2 shards (k0 = 0 semantics); one
    covariance over both partitions (covtype='all', quirk Q1)."""
    m = _all_reduce(ring, _moments(s1, valid1) + _moments(s2, valid2))
    cov = _cov_from_moments(m, s1.shape[-1]).to(s1.dtype)
    w1s, log_j, _ = _whiten_from_cov(s1, cov)
    w2s, _, _ = _whiten_from_cov(s2, cov)
    d2, _ = _ring_knn_local(w1s, w2s, kmax, ring, n2_global, False, select,
                            batched=False, n_query=n1_global)
    ng = torch.tensor(n1_global, dtype=s1.dtype, device=s1.device)
    return _reduce_mle(_pad_columns(d2, kmax), lnl1, w1, valid1, log_j,
                       kmax=kmax, n_global=ng, ndim=ndim,
                       log_prior_volume=log_prior_volume, k_start=0,
                       ring=ring)


# ---------------------------------------------------------------------------
# the 1-D programs (full host arrays in, the same result on every rank)
# ---------------------------------------------------------------------------

def _shard(ring: Ring, rows: int) -> slice:
    if rows % ring.size:
        raise ValueError(f"{rows} rows do not split into {ring.size} equal "
                         "shards; pad them first (pad_for_mesh)")
    loc = rows // ring.size
    return slice(ring.rank * loc, (ring.rank + 1) * loc)


def _f32(a, sl, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a[sl], np.float32), device=dev)[None]


def make_sharded_evidence(group=None, *, kmax: int, ndim: int,
                          engine: str = "auto", device="cuda"):
    """The ring's auto-evidence program (``make_sharded_evidence``):
    ``fn(samples (Np, d), lnlike, weights, valid (Np,), n_global,
    log_prior_volume)`` with Np a multiple of the ring's size; each rank
    takes its shard of the full arrays.  Returns the (kmax,) MLE row
    (column 0 unused) on every rank."""
    ring, dev = ring_group(group), rank_device(device)
    _check_transport(ring, dev)
    select = selector(engine, "fast", width=ndim)

    def fn(samples, lnlike, weights, valid, n_global, log_prior_volume):
        sl = _shard(ring, samples.shape[0])
        lpv = torch.tensor([log_prior_volume], dtype=torch.float32,
                           device=dev)
        mle = _evidence_step_local(
            _f32(samples, sl, dev), _f32(lnlike, sl, dev),
            _f32(weights, sl, dev), _f32(valid, sl, dev), [int(n_global)],
            lpv, kmax=kmax, ndim=ndim, ring=ring, select=select,
            batched=False)
        return mle[0].cpu().numpy().astype(np.float64)
    return fn


def make_sharded_cross_evidence(group=None, *, kmax: int, ndim: int,
                                engine: str = "auto", device="cuda"):
    """The ring's cross-evidence program
    (``make_sharded_cross_evidence``): ``fn(s1 (N1p, d), lnl1, w1, valid1,
    s2 (N2p, d), valid2, n1_global, n2_global, log_prior_volume)``; returns
    the (kmax,) MLE row with k0 = 0 columns (the caller slices [1:], quirk
    Q2)."""
    ring, dev = ring_group(group), rank_device(device)
    _check_transport(ring, dev)
    select = selector(engine, "fast", width=ndim)

    def fn(s1, lnl1, w1, valid1, s2, valid2, n1_global, n2_global,
           log_prior_volume):
        sl1, sl2 = _shard(ring, s1.shape[0]), _shard(ring, s2.shape[0])
        lpv = torch.tensor([log_prior_volume], dtype=torch.float32,
                           device=dev)
        mle = _cross_evidence_step_local(
            _f32(s1, sl1, dev), _f32(lnl1, sl1, dev), _f32(w1, sl1, dev),
            _f32(valid1, sl1, dev), _f32(s2, sl2, dev),
            _f32(valid2, sl2, dev), [int(n1_global)], [int(n2_global)], lpv,
            kmax=kmax, ndim=ndim, ring=ring, select=select)
        return mle[0].cpu().numpy().astype(np.float64)
    return fn


def make_sharded_knn(group=None, *, k: int, self_mode: bool,
                     engine: str = "auto", device="cuda"):
    """The ring's selection program (``make_sharded_knn``): ``fn(q (Nqp,
    d), r (Nrp, d), n_global)`` with f32-exact centred rows, each a
    multiple of the ring's size; returns (d2 (Nqp, k) f32, idx (Nqp, k)
    int32 global row ids) on every rank.  Selection only, with the
    refine path's selection of ``engine``, so the host can refine the
    candidates in f64."""
    ring, dev = ring_group(group), rank_device(device)
    _check_transport(ring, dev)

    def fn(q, r, n_global):
        select = selector(engine, "refine", width=q.shape[1])
        qd = _f32(q, _shard(ring, q.shape[0]), dev)
        rd = qd if self_mode else _f32(r, _shard(ring, r.shape[0]), dev)
        d2, idx = _ring_knn_local(qd, rd, k, ring, [int(n_global)],
                                  self_mode, select, batched=False)
        d2, idx = _all_gather(ring, d2[0]), _all_gather(ring, idx[0])
        return (d2.reshape(-1, d2.shape[-1]).cpu().numpy(),
                idx.reshape(-1, idx.shape[-1]).cpu().numpy())
    return fn


# ---------------------------------------------------------------------------
# host-facing wrappers
# ---------------------------------------------------------------------------

def _ring_rows(n: int, size: int) -> int:
    """n rounded up to a multiple of the ring's size."""
    return -(-n // size) * size


def pad_for_mesh(samples: np.ndarray, lnlike: np.ndarray,
                 weights: Optional[np.ndarray], n_devices: int):
    """Pad arrays so each rank gets an equal shard; returns (s, lnl, w,
    valid).  Unlike JAX's, no compile-bucket padding: the kernels take any
    row count."""
    n, d = samples.shape
    if weights is None:
        weights = np.ones(n)
    npad = _ring_rows(n, n_devices) - n
    s = np.concatenate([samples, np.zeros((npad, d))], axis=0)
    lnl = np.concatenate([lnlike, np.full(npad, -1e30)])
    w = np.concatenate([weights, np.ones(npad)])
    valid = np.concatenate([np.ones(n), np.zeros(npad)])
    return s, lnl, w, valid


def _pad_rows(arr: np.ndarray, total: int) -> np.ndarray:
    npad = total - arr.shape[0]
    if npad <= 0:
        return arr
    return np.concatenate([arr, np.zeros((npad,) + arr.shape[1:],
                                         arr.dtype)])


def sharded_knn_candidates(query64: np.ndarray, ref64: Optional[np.ndarray],
                           k_sel: int, *, group=None, engine: str = "auto",
                           device="cuda") -> np.ndarray:
    """Ring-select k_sel candidate indices for (already whitened) f64
    points; ``ref64=None`` is self mode.  Returns (Nq, k_sel) int32 global
    row indices into the reference set (-1 = absent), on every rank."""
    ring = ring_group(group)
    self_mode = ref64 is None
    # centre once in f64 before the f32 cast: every shard then holds the
    # same f32 coordinates as one selection over the whole chain would
    query64, r64 = center_f64(query64, ref64)
    nq, nr = query64.shape[0], r64.shape[0]
    q_in = _pad_rows(query64, _ring_rows(nq, ring.size))
    r_in = q_in if self_mode else _pad_rows(r64, _ring_rows(nr, ring.size))
    fn = make_sharded_knn(ring, k=min(k_sel, nr), self_mode=self_mode,
                          engine=engine, device=device)
    _, idx = fn(q_in, r_in, nr)
    return idx[:nq]


def sharded_auto_evidence(samples: np.ndarray, lnlike: np.ndarray,
                          weights: Optional[np.ndarray] = None,
                          *, kmax: int = 5, prior_volume: float = 1.0,
                          sum_adjusted_weights: Optional[float] = None,
                          group=None, precision: str = "fast",
                          pad_candidates: int = 4, engine: str = "auto",
                          device="cuda") -> np.ndarray:
    """Auto evidence over the ring (the contract of ``evidence_fn``):
    returns ln Z for k = 1..kmax-1 on every rank.  ``precision`` "fast" or
    "refine" (module docstring)."""
    kmax = max(2, kmax)
    ring = ring_group(group)
    n, ndim = samples.shape
    samples = np.asarray(samples, np.float64)
    lnlike = np.asarray(lnlike, np.float64)
    w_np = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    sumw = (float(np.sum(w_np)) if sum_adjusted_weights is None
            else float(sum_adjusted_weights))

    if precision == "refine":
        stats = whiten_stats(samples)
        s1w = apply_whiten(samples, stats)

        def select(ks):
            return sharded_knn_candidates(s1w, None, ks, group=ring,
                                          engine=engine, device=device)
        idx = select(min(n, kmax + pad_candidates))
        dknn = guarded_refine_knn_f64(s1w, s1w, idx, min(kmax, n),
                                      self_mode=True, reselect=select)
        mle = log_evidence_from_knn_np(
            dknn, lnlike, w_np, sumw, ndim,
            log_jacobian=stats.log_jacobian,
            log_prior_volume=math.log(prior_volume), k_start=1, nsamples=n)
        # n < kmax: only the first n-1 neighbour columns exist; the rest
        # are NaN, keeping the documented kmax-1 return width
        out = np.full(kmax - 1, np.nan)
        out[: len(mle) - 1] = mle[1:]
        return out

    # centre in f64 before the f32 cast (translation-invariant; keeps the
    # selection ranking and the covariance's conditioning for offset chains)
    samples = samples - samples.mean(axis=0)
    s, lnl, w, valid = pad_for_mesh(samples, lnlike, w_np, ring.size)
    fn = make_sharded_evidence(ring, kmax=kmax, ndim=ndim, engine=engine,
                               device=device)
    mle = fn(s, lnl, w, valid, n, math.log(prior_volume))
    if sum_adjusted_weights is not None:
        # importance reweighting enters only through SumW (quirk Q7)
        mle[1:] += np.log(sumw) - np.log(float(np.sum(w_np)))
    if n < kmax:
        # column k needs a k-th non-self neighbour (n-1 >= k)
        mle[n:] = np.nan
    return mle[1:]


def sharded_cross_evidence(samples1: np.ndarray, lnlike1: np.ndarray,
                           samples2: np.ndarray,
                           weights1: Optional[np.ndarray] = None,
                           *, kmax: int = 5, prior_volume: float = 1.0,
                           sum_adjusted_weights: Optional[float] = None,
                           group=None, precision: str = "fast",
                           pad_candidates: int = 4, engine: str = "auto",
                           device="cuda") -> np.ndarray:
    """Cross evidence over the ring (the contract of ``evidence_fn`` with
    ``samples2``): ln Z for k = 1..kmax-1 on every rank.  See
    ``sharded_auto_evidence``."""
    kmax = max(2, kmax)
    ring = ring_group(group)
    n1, ndim = samples1.shape
    n2 = samples2.shape[0]
    samples1 = np.asarray(samples1, np.float64)
    samples2 = np.asarray(samples2, np.float64)
    lnlike1 = np.asarray(lnlike1, np.float64)
    w1_np = (np.ones(n1) if weights1 is None
             else np.asarray(weights1, np.float64))
    sumw = (float(np.sum(w1_np)) if sum_adjusted_weights is None
            else float(sum_adjusted_weights))

    if precision == "refine":
        # covtype='all' (quirk Q1): one covariance over both partitions
        stats = whiten_stats(np.concatenate([samples1, samples2]))
        s1w = apply_whiten(samples1, stats)
        s2w = apply_whiten(samples2, stats)

        def select(ks):
            return sharded_knn_candidates(s1w, s2w, ks, group=ring,
                                          engine=engine, device=device)
        idx = select(min(n2, kmax + pad_candidates))
        dknn = guarded_refine_knn_f64(s1w, s2w, idx, min(kmax, n2),
                                      self_mode=False, reselect=select)
        mle = log_evidence_from_knn_np(
            dknn, lnlike1, w1_np, sumw, ndim,
            log_jacobian=stats.log_jacobian,
            log_prior_volume=math.log(prior_volume), k_start=0, nsamples=n1)
        out = np.full(kmax - 1, np.nan)
        out[: len(mle) - 1] = mle[1:]
        return out

    # one f64 shift for BOTH partitions (cross distances are relative)
    mu_c = samples1.mean(axis=0)
    s1, lnl1, w1, valid1 = pad_for_mesh(samples1 - mu_c, lnlike1, w1_np,
                                        ring.size)
    nb2 = _ring_rows(n2, ring.size)
    s2 = _pad_rows(samples2 - mu_c, nb2)
    valid2 = np.concatenate([np.ones(n2), np.zeros(nb2 - n2)])
    fn = make_sharded_cross_evidence(ring, kmax=kmax, ndim=ndim,
                                     engine=engine, device=device)
    mle = fn(s1, lnl1, w1, valid1, s2, valid2, n1, n2,
             math.log(prior_volume))
    if sum_adjusted_weights is not None:
        mle = mle + (np.log(sumw) - np.log(float(np.sum(w1_np))))
    if n2 < kmax:
        # cross column c uses the (c+1)-th reference neighbour (k0=0)
        mle[n2:] = np.nan
    return mle[1:]


def make_sharded_device_refine(group=None, *, k_sel: int, kmax: int,
                               engine: str, self_mode: bool = True,
                               device="cuda"):
    """The ring's device-precision program
    (``make_sharded_device_refine``): ``fn(q64 (N, d), r64 (Nr, d), scal
    (N,), n_ref, ndim, inv_s2)`` with the full f64 device tensors of
    ``ops/pipeline.py:_device_refine_prepare`` on every rank; rank p takes
    query rows p * ceil(N / P) .. and runs ``fused_refine_dotp`` on them
    against the whole reference at that row offset (no kernel self pin: the
    own row wins a slot at distance 0 and is zeroed by its global row).
    Returns the (P, kmax+1) partials [dotp_k..., thin_count] on every
    rank."""
    ring, dev = ring_group(group), rank_device(device)
    _check_transport(ring, dev)

    def fn(q64, r64, scal, n_ref, ndim, inv_s2):
        n = q64.shape[0]
        loc = -(-n // ring.size)
        lo = min(n, ring.rank * loc)
        hi = min(n, lo + loc)
        if hi > lo:
            flat = fused_refine_dotp(
                q64[lo:hi], r64, scal[lo:hi], n_ref, ndim, inv_s2,
                k_sel=k_sel, kmax=kmax, engine=engine, self_mode=self_mode,
                offset=lo, kernel_self_pin=False)
        else:
            flat = torch.zeros(kmax + 1, dtype=torch.float64, device=dev)
        return _all_gather(ring, flat).cpu().numpy()
    return fn


def sharded_device_refine_evidence(samples: np.ndarray, lnlike: np.ndarray,
                                   weights: Optional[np.ndarray] = None, *,
                                   samples2: Optional[np.ndarray] = None,
                                   kmax: int = 2, prior_volume: float = 1.0,
                                   sum_adjusted_weights=None,
                                   pad_candidates: int = 4, group=None,
                                   engine: str = "auto",
                                   device="cuda") -> np.ndarray:
    """``device`` precision over the ring: host f64 whitening, the f64
    coordinates on every rank's card, each rank's shard of the query rows
    selected, refined and reduced there, the partials gathered and
    combined in host f64.  Returns k = 1..kmax-1 on every rank; auto mode,
    or cross when ``samples2`` is given.  ndim > ``D_MAX`` (the kernels'
    widest layout) and a non-finite sum take the ring's refine path; thin
    margins retry with 4 pad + 8 candidates, as in JAX."""
    kmax = max(2, kmax)
    samples = np.asarray(samples, np.float64)
    ring = ring_group(group)

    def refine():
        kw = dict(kmax=kmax, prior_volume=prior_volume,
                  sum_adjusted_weights=sum_adjusted_weights, group=ring,
                  precision="refine", pad_candidates=pad_candidates,
                  engine=engine, device=device)
        if samples2 is None:
            return sharded_auto_evidence(samples, lnlike, weights, **kw)
        return sharded_cross_evidence(samples, lnlike, samples2, weights,
                                      **kw)

    if samples.shape[1] > D_MAX:
        logger.info("sharded device-refine: ndim %d > %d; falling back to "
                    "the sharded refine path", samples.shape[1], D_MAX)
        return refine()
    dev = rank_device(device)
    t, host = _device_refine_prepare(samples, lnlike, weights, kmax,
                                     pad_candidates, samples2=samples2,
                                     device=dev)
    # kmax_eff, not kmax: a tiny reference partition caps the candidates
    fn = make_sharded_device_refine(ring, k_sel=host["k_sel"],
                                    kmax=host["kmax_eff"], engine=engine,
                                    self_mode=samples2 is None, device=dev)
    parts = np.asarray(fn(t["q64"], t["r64"], t["scal"], host["n_ref"],
                          host["ndim"], host["inv_s2"]), np.float64)
    flat = np.concatenate([parts[:, :host["kmax_eff"]].sum(axis=0),
                           [parts[:, -1].sum()]])
    retry_pad = 4 * pad_candidates + 8
    row = device_refine_finish(
        flat, host, prior_volume=prior_volume,
        sum_adjusted_weights=sum_adjusted_weights,
        last=(pad_candidates >= 32
              or min(kmax + retry_pad, host["n_ref"]) <= host["k_sel"]))
    if row is NONFINITE:
        # (d2 inv_s2)^(ndim/2) scal left f64 range (far outlier rows): the
        # refine path's log-space estimator has unlimited range
        logger.warning("sharded device-refine: non-finite sum; falling "
                       "back to the sharded refine path")
        return refine()
    if row is THIN:
        logger.info("sharded device-refine: thin margins on %d rows; "
                    "re-running with %d extra candidates", int(flat[-1]),
                    retry_pad)
        return sharded_device_refine_evidence(
            samples, lnlike, weights, samples2=samples2, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights,
            pad_candidates=retry_pad, group=ring, engine=engine, device=dev)
    return row


# ---------------------------------------------------------------------------
# dp x ring: a batch of chains data-parallel over dp, each chain's rows
# round its ring
# ---------------------------------------------------------------------------

# Coordinate-width classes of the JAX grid programs, kept as the grid
# driver's chunking key: the CUDA kernels pad to the same widths (8, 16).
GRID_DPAD_CLASSES = (8, 16)
GRID_DPAD = GRID_DPAD_CLASSES[-1]


def _dpad_class(ndim: int) -> int:
    for w in GRID_DPAD_CLASSES:
        if ndim <= w:
            return w
    raise ValueError(f"ndim {ndim} > GRID_DPAD {GRID_DPAD}")


# Chains per batched launch in the grid driver's chunks and in
# sharded_grid_evidence_refine.
GRID_BATCH_QUANTUM = 4


def _dp_members(layout: GridLayout, b_true: int) -> list:
    """The chains of this rank's ring: a contiguous share of the batch."""
    per = -(-b_true // layout.dp)
    return list(range(layout.dp_index * per,
                      min(b_true, (layout.dp_index + 1) * per)))


def _gather_dp(layout: GridLayout, rows: np.ndarray, b_true: int,
               dev) -> np.ndarray:
    """Every ring's (members, ...) result rows, in chain order, on every
    rank (the counterpart of out_specs=P("dp"))."""
    per = -(-b_true // layout.dp)
    buf = np.full((per,) + rows.shape[1:], np.nan)
    buf[:len(rows)] = rows
    got = _all_gather(layout.world,
                      torch.as_tensor(buf, device=dev)).cpu().numpy()
    n = layout.ring.size
    return np.concatenate([got[i * n] for i in range(layout.dp)])[:b_true]


def _normalize_chains(chains):
    norm = []
    for c in chains:
        if isinstance(c, dict):
            s = np.asarray(c["samples"], np.float64)
            lnl = np.asarray(c["loglikes"], np.float64)
            w = np.asarray(c.get("weights", np.ones(len(s))), np.float64)
        else:
            s = np.asarray(c[0], np.float64)
            lnl = np.asarray(c[1], np.float64)
            w = (np.asarray(c[2], np.float64) if len(c) > 2
                 else np.ones(len(s)))
        norm.append((s, lnl, w))
    return norm


def _grid_batch_layout(norm):
    """(b_true, b_pad, n_pad, ndim) of a batch on one card: the batch and
    the rows are not padded (the kernels take per-member counts), so
    b_pad = b_true and n_pad is the longest chain; ndim is the widest
    chain's (narrower chains are zero-padded, which adds exactly 0 to
    their distances)."""
    b_true = len(norm)
    return (b_true, b_true, max(s.shape[0] for s, _, _ in norm),
            max(s.shape[1] for s, _, _ in norm))


def _references(chains2, b_true):
    refs = [np.asarray(s2, np.float64) for s2 in chains2]
    if len(refs) != b_true:
        raise ValueError("chains2 must match chains 1:1")
    return refs


def _whiten_chain(s, ref):
    """Host f64 whitening of one chain (combined s1+s2 covariance in cross
    mode — covtype='all', quirk Q1), then centring on the reference set in
    f64, which keeps the f32 selection ranking precise for strongly offset
    coordinates.  Returns (stats, query, ref or None)."""
    if ref is None:
        stats = whiten_stats(s)
        sw, _ = center_f64(apply_whiten(s, stats), None)
        return stats, sw, None
    stats = whiten_stats(np.concatenate([s, ref]))
    sw, rw = center_f64(apply_whiten(s, stats), apply_whiten(ref, stats))
    return stats, sw, rw


def _stacked(arrays, rows, width, dtype):
    """Zero-padded (B, rows, width) host stack of (n_b, d_b) arrays."""
    out = np.zeros((len(arrays), rows, width), dtype)
    for b, a in enumerate(arrays):
        out[b, :a.shape[0], :a.shape[1]] = a
    return out


def make_sharded_grid_evidence(group=None, dp: int = 1, *, kmax: int,
                               ndim: int, engine: str = "auto",
                               device="cuda"):
    """The dp x ring auto-evidence program (``make_sharded_grid_evidence``):
    ``fn(S (B, Np, d), L, W, V (B, Np), NG (B,), LPV (B,), SWS (B,))`` with
    the chains centred and Np a multiple of the ring size; ring i takes its
    share of the B chains, each chain's rows sharded round the ring and
    searched by the engine's batched selection.  Returns the (B, kmax) MLE
    rows on every rank, the importance shift SWS added past column 0."""
    layout = grid_layout(dp, group)
    ring, dev = layout.ring, rank_device(device)
    _check_transport(ring, dev)
    select = selector(engine, "grid_fast", width=ndim)

    def fn(S, L, W, V, NG, LPV, SWS):
        b_true = S.shape[0]
        members = _dp_members(layout, b_true)
        rows = np.zeros((0, kmax))
        if members:
            sl = _shard(ring, S.shape[1])

            def f32(a):
                return torch.as_tensor(
                    np.asarray(a[members][:, sl], np.float32), device=dev)
            lpv = torch.as_tensor(np.asarray(LPV, np.float32)[members],
                                  device=dev)
            mle = _evidence_step_local(
                f32(S), f32(L), f32(W), f32(V),
                [int(NG[i]) for i in members], lpv, kmax=kmax, ndim=ndim,
                ring=ring, select=select, batched=True)
            rows = mle.cpu().numpy().astype(np.float64)
            rows[:, 1:] += np.asarray(SWS, np.float64)[members][:, None]
        return _gather_dp(layout, rows, b_true, dev)
    return fn


def make_sharded_grid_knn(group=None, dp: int = 1, *, k: int,
                          self_mode: bool = True, engine: str = "auto",
                          device="cuda"):
    """The dp x ring selection program (``make_sharded_grid_knn``):
    ``fn(Q (B, Np, d), R (B, Mp, d), NG (B,))`` with whitened, centred f32
    rows (``R`` is ``Q`` in self mode), Np and Mp multiples of the ring
    size; ring i takes its share of the chains, each selected round the
    ring by the engine's batched selection.  Returns (d2, idx) (B, Np, k)
    with global row ids, on every rank."""
    layout = grid_layout(dp, group)
    ring, dev = layout.ring, rank_device(device)
    _check_transport(ring, dev)

    def fn(Q, R, NG):
        b_true, n_pad = Q.shape[0], Q.shape[1]
        kk = min(k, R.shape[1])
        members = _dp_members(layout, b_true)
        d2 = np.zeros((0, n_pad, kk))
        idx = np.zeros((0, n_pad, kk))
        if members:
            select = selector(engine, "batched", width=Q.shape[2])
            qd = torch.as_tensor(Q[members][:, _shard(ring, n_pad)],
                                 dtype=torch.float32, device=dev)
            rd = qd if self_mode else torch.as_tensor(
                R[members][:, _shard(ring, R.shape[1])],
                dtype=torch.float32, device=dev)
            ng = [int(NG[i]) for i in members]
            dd, ii = _ring_knn_local(qd, rd, kk, ring, ng, self_mode, select,
                                     batched=True)
            # the ring's query shards, back in row order
            dd = _all_gather(ring, dd).permute(1, 0, 2, 3)
            ii = _all_gather(ring, ii).permute(1, 0, 2, 3)
            d2 = dd.reshape(len(members), n_pad, -1).cpu().numpy()
            idx = ii.reshape(len(members), n_pad, -1).cpu().numpy()
        return (_gather_dp(layout, d2, b_true, dev).astype(np.float32),
                _gather_dp(layout, idx, b_true, dev).astype(np.int32))
    return fn


def sharded_grid_auto_evidence(chains, *, kmax: int = 2,
                               prior_volumes=None, sumw_log_shifts=None,
                               engine: str = "auto", group=None, dp: int = 1,
                               device="cuda") -> np.ndarray:
    """Auto evidence for a batch of chains in ``fast`` precision (f32).

    ``chains``: a sequence of (samples, lnlike[, weights]) tuples (or dicts
    with those keys) of one dimensionality.  Each chain is centred in f64
    on the host and cast to f32 (unlike JAX's program, which takes f32
    moments of uncentred chains: the same function, without their
    cancellation); then whitened from its masked moments, searched for
    kmax neighbours and reduced per chain (``_reduce_mle``'s semantics).
    With one rank, on ``device`` in ONE batched selection launch with each
    member's row count; over a dp x ring layout, ``make_sharded_grid_
    evidence``.  ``sumw_log_shifts`` are the per-chain ln(SumW_adj / SumW)
    of an importance reweighting (quirk Q7).  Returns (len(chains),
    kmax-1) ln Z values."""
    kmax = max(2, kmax)
    layout = grid_layout(dp, group)
    dev = rank_device(device)
    norm = _normalize_chains(chains)
    b_true, _, n_rows, ndim = _grid_batch_layout(norm)
    if any(s.shape[1] != ndim for s, _, _ in norm):
        raise ValueError("sharded_grid_auto_evidence takes chains of one "
                         "dimensionality")
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)
    shifts = (np.zeros(b_true) if sumw_log_shifts is None
              else np.asarray(sumw_log_shifts, np.float64))
    ns = [s.shape[0] for s, _, _ in norm]
    if layout.world.size > 1:
        n_rows = _ring_rows(n_rows, layout.ring.size)
    samples = np.zeros((b_true, n_rows, ndim))
    lnl = np.full((b_true, n_rows), -1e30)
    w = np.ones((b_true, n_rows))
    valid = np.zeros((b_true, n_rows))
    for i, (s, l, wt) in enumerate(norm):
        samples[i, :ns[i]] = s - s.mean(axis=0)
        lnl[i, :ns[i]] = l
        w[i, :ns[i]] = wt
        valid[i, :ns[i]] = 1.0
    if layout.world.size > 1:
        fn = make_sharded_grid_evidence(layout.world, dp, kmax=kmax,
                                        ndim=ndim, engine=engine, device=dev)
        return fn(samples, lnl, w, valid, ns, np.log(prior_volumes),
                  shifts)[:, 1:]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    S, L, W, V = f32(samples), f32(lnl), f32(w), f32(valid)
    white, log_j, _ = whiten_masked(S, V)
    k_sel = min(kmax, n_rows)
    d2, _ = selector(engine, "grid_fast", width=ndim)(
        white, white, k_sel, self_mode=True, nr=ns, nq=ns)
    if k_sel < kmax:
        d2 = torch.cat([d2, d2.new_full((b_true, n_rows, kmax - k_sel),
                                        math.inf)], dim=2)
    mle = log_evidence_from_knn(
        d2, L, W, (W * V).sum(dim=1), ndim, log_jacobian=log_j,
        log_prior_volume=f32(np.log(prior_volumes)), k_start=1,
        nsamples=f32(ns), valid=V, squared=True)
    # importance reweighting enters only through SumW (quirk Q7), as a
    # per-chain log shift of every column past the self match
    mle = mle.cpu().numpy().astype(np.float64)
    return mle[:, 1:] + shifts[:, None]


def make_sharded_grid_device_refine(group=None, dp: int = 1, *, k_sel: int,
                                    kmax: int, engine: str,
                                    cross: bool = False, device="cuda"):
    """The dp x ring device-precision program
    (``make_sharded_grid_device_refine``): ``fn(q64 (B, Nq, d), r64 (B, Nr,
    d), scal (B, Nq), nq, nr, ndims, inv_s2s)`` with the f64 tensors on the
    rank's card (``r64`` is ``q64`` in auto mode); ring i takes its share
    of the chains, and ring rank p their query rows p * ceil(Nq / P) ..,
    searched against each chain's whole reference by the engine's batched
    selection at that row offset, refined and reduced there.  Returns the
    (B, P, kmax+1) partials on every rank."""
    layout = grid_layout(dp, group)
    ring, dev = layout.ring, rank_device(device)
    _check_transport(ring, dev)

    def fn(q64, r64, scal, nq, nr, ndims, inv_s2s):
        b_true, n_q = q64.shape[0], q64.shape[1]
        members = _dp_members(layout, b_true)
        loc = -(-n_q // ring.size)
        lo = min(n_q, ring.rank * loc)
        hi = min(n_q, lo + loc)
        flat = torch.zeros((len(members), kmax + 1), dtype=torch.float64,
                           device=dev)
        if members and hi > lo:
            m = torch.as_tensor(members, device=q64.device)
            flat = fused_refine_dotp_batch(
                q64[m, lo:hi], r64[m], scal[m, lo:hi],
                [min(max(nq[i] - lo, 0), hi - lo) for i in members],
                [nr[i] for i in members], [ndims[i] for i in members],
                [inv_s2s[i] for i in members], k_sel=k_sel, kmax=kmax,
                engine=engine, self_mode=not cross, offset=lo,
                kernel_self_pin=False)
        parts = _all_gather(ring, flat).permute(1, 0, 2).cpu().numpy()
        return _gather_dp(layout, parts, b_true, dev)
    return fn


def sharded_grid_device_refine_evidence(chains, *, kmax: int = 2,
                                        prior_volumes=None,
                                        sum_adjusted_weights=None,
                                        chains2=None,
                                        pad_candidates: int = 4,
                                        engine: str = "auto",
                                        group=None, dp: int = 1,
                                        device="cuda",
                                        defer: bool = False):
    """Parity-grade batched evidence with scalars-only device->host
    traffic: host f64 whitening per chain, one upload of the batch's f64
    coordinates, the batched selection, f64 refinement and reduction on
    the card, f64 host bookkeeping.  With one rank ONE batched selection
    launch over the batch; over a dp x ring layout
    ``make_sharded_grid_device_refine``.  Auto mode, or cross mode when
    ``chains2`` is a matching sequence of reference-partition sample arrays
    (combined covariance — quirk Q1; k0=0 semantics).  Chains may mix
    dimensionalities up to ``GRID_DPAD``.  Returns (len(chains), kmax-1) at
    ~1e-13 lnZ of the refine path.

    Thin candidate margins re-run the batch with 4*pad+8 candidates while
    pad < 32 (k_sel = kmax+4, then kmax+24, then kmax+104; past k = 256
    the wide kernel selects).  A chain whose sum is not finite takes the
    host-refine path.

    ``defer=True`` returns a zero-argument finalize callable instead: the
    batch is launched at once, but the fetch (and any retry) waits until
    the callable runs, so a driver can launch many batches back to back
    (over a layout every rank must call it).
    """
    kmax = max(2, kmax)
    layout = grid_layout(dp, group)
    dev = rank_device(device)
    norm = _normalize_chains(chains)
    b_true, _, n_rows, width = _grid_batch_layout(norm)
    _dpad_class(width)          # raises past GRID_DPAD
    cross = chains2 is not None
    refs = _references(chains2, b_true) if cross else None
    n_refs = ([r.shape[0] for r in refs] if cross
              else [s.shape[0] for s, _, _ in norm])
    if min(n_refs) <= kmax:
        raise ValueError(f"reference partitions shorter than kmax+1="
                         f"{kmax + 1} rows are not supported by the batched "
                         "device-refine path; use evidence_fn per chain")
    # cap by the LARGEST reference partition: the batched selection gives a
    # shorter member absent slots past its own count, so a small chain must
    # not starve the large chains of candidates nor disable their retry
    k_sel = min(kmax + pad_candidates, max(n_refs))
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)

    queries, references, scals, hosts = [], [], [], []
    for i, (s, lnl, w) in enumerate(norm):
        n, d = s.shape
        stats, sw, rw = _whiten_chain(s, refs[i] if cross else None)
        queries.append(sw)
        if cross:
            references.append(rw)
        lnl_max = float(np.max(lnl))
        scals.append(np.exp(lnl - lnl_max) / w)
        hosts.append(dict(n=n, ndim=d, lnl_max=lnl_max, cross=cross,
                          log_j=stats.log_jacobian, sum_w=float(np.sum(w)),
                          inv_s2=n_refs[i] ** (2.0 / d) / d,
                          n_ref=n_refs[i], k_sel=k_sel, kmax=kmax,
                          kmax_eff=kmax))
    q64 = torch.as_tensor(_stacked(queries, n_rows, width, np.float64),
                          device=dev)
    r64 = (torch.as_tensor(_stacked(references, max(n_refs), width,
                                    np.float64), device=dev)
           if cross else q64)
    scal = torch.as_tensor(
        _stacked([x[:, None] for x in scals], n_rows, 1, np.float64)[..., 0],
        device=dev)
    args = (q64, r64, scal, [h["n"] for h in hosts], n_refs,
            [h["ndim"] for h in hosts], [h["inv_s2"] for h in hosts])
    if layout.world.size > 1:
        # collectives now, on every rank; the combine of each chain's ring
        # partials waits for the finalize
        parts_ring = make_sharded_grid_device_refine(
            layout.world, dp, k_sel=k_sel, kmax=kmax, engine=engine,
            cross=cross, device=dev)(*args)

        def fetch():
            return parts_ring.sum(axis=1)
    else:
        parts_dev = fused_refine_dotp_batch(
            *args, k_sel=k_sel, kmax=kmax, engine=engine, self_mode=not cross)

        def fetch():
            return parts_dev.cpu().numpy()

    def _finalize() -> np.ndarray:
        parts = fetch()
        thin = parts[:, -1].sum()
        if thin > 0:
            retry_pad = 4 * pad_candidates + 8
            if (pad_candidates < 32
                    and min(kmax + retry_pad, max(n_refs)) > k_sel):
                logger.info("grid device-refine: thin margins on %d rows; "
                            "re-running with %d extra candidates",
                            int(thin), retry_pad)
                return sharded_grid_device_refine_evidence(
                    chains, kmax=kmax, prior_volumes=prior_volumes,
                    sum_adjusted_weights=sum_adjusted_weights,
                    chains2=chains2, pad_candidates=retry_pad,
                    engine=engine, group=layout.world, dp=dp, device=dev)
            logger.warning(
                "grid device-refine: %d rows had thin candidate margins "
                "(near-tied neighbour distances) and the candidate set "
                "cannot be widened further; use sharded_grid_evidence_"
                "refine if exact tie ordering matters", int(thin))
        out = np.zeros((b_true, kmax - 1))
        for i in range(b_true):
            sw_i = (None if sum_adjusted_weights is None
                    else float(sum_adjusted_weights[i]))
            if not np.all(np.isfinite(parts[i, :-1])):
                logger.warning("grid device-refine: non-finite sum on chain "
                               "%d; host-refine fallback", i)
                s, lnl, w = norm[i]
                out[i] = host_refine_evidence(
                    s, lnl, w, samples2=refs[i] if cross else None,
                    kmax=kmax, prior_volume=float(prior_volumes[i]),
                    sum_adjusted_weights=sw_i, engine=engine, device=dev)
                continue
            flat = np.concatenate([parts[i, :-1], [0.0]])
            out[i] = device_refine_finish(
                flat, hosts[i], prior_volume=float(prior_volumes[i]),
                sum_adjusted_weights=sw_i, last=True)
        return out

    if defer:
        return _finalize
    return _finalize()


def sharded_grid_evidence_refine(chains, *, kmax: int = 2,
                                 prior_volumes=None,
                                 sum_adjusted_weights=None,
                                 chains2=None,
                                 pad_candidates: int = 4,
                                 engine: str = "auto", group=None,
                                 dp: int = 1,
                                 device="cuda") -> np.ndarray:
    """Parity-grade batched evidence in ``refine`` precision: host f64
    whitening per chain, batched f32 selection of each width class in
    chunks (every chunk launched before any is fetched; over a dp x ring
    layout, ``make_sharded_grid_knn`` on chunks of lcm(GRID_BATCH_QUANTUM,
    dp) chains), host f64 candidate refinement with the sufficiency guard
    (whose reselect goes round the chain's ring) and host f64 estimator.
    Returns (len(chains), kmax-1).

    Auto mode when ``chains2`` is None; cross mode when it is a matching
    sequence of reference-partition sample arrays (per-chain NNs of s1
    searched in s2, k0=0 semantics; combined s1+s2 covariance — quirk Q1).
    """
    kmax = max(2, kmax)
    layout = grid_layout(dp, group)
    dev = rank_device(device)
    norm = _normalize_chains(chains)
    b_true = len(norm)
    ndims = [s.shape[1] for s, _, _ in norm]
    # the stacks below are a width class wide (8 or 16 columns)
    select_batch = selector(engine, "batched", width=GRID_DPAD)
    select = selector(engine, "refine", width=GRID_DPAD)
    ns = [s.shape[0] for s, _, _ in norm]
    if max(ndims) > GRID_DPAD:
        raise ValueError(f"ndim {max(ndims)} > GRID_DPAD {GRID_DPAD}")
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)
    cross = chains2 is not None
    refs = _references(chains2, b_true) if cross else None
    n_refs = [r.shape[0] for r in refs] if cross else ns
    k_sel = min(kmax + pad_candidates, max(n_refs))
    whitened = [_whiten_chain(s, refs[i] if cross else None)
                for i, (s, _, _) in enumerate(norm)]
    ring_n = layout.ring.size
    multi = layout.world.size > 1
    chunk = math.lcm(GRID_BATCH_QUANTUM, layout.dp)
    fn = (make_sharded_grid_knn(layout.world, dp, k=k_sel,
                                self_mode=not cross, engine=engine,
                                device=dev) if multi else None)

    by_class: dict = {}
    for i in range(b_true):
        by_class.setdefault(_dpad_class(ndims[i]), []).append(i)
    pending = []
    for dpad, indices in by_class.items():
        for c0 in range(0, len(indices), chunk):
            members = indices[c0:c0 + chunk]
            rows = max(ns[i] for i in members)
            ref_rows = max(n_refs[i] for i in members)
            if multi:
                rows = _ring_rows(rows, ring_n)
                ref_rows = _ring_rows(ref_rows, ring_n)
            q = _stacked([whitened[i][1] for i in members], rows, dpad,
                         np.float32)
            r = q if not cross else _stacked(
                [whitened[i][2] for i in members], ref_rows, dpad,
                np.float32)
            if multi:
                _, idx = fn(q, r, [n_refs[i] for i in members])
                pending.append((members, q, r, idx))
                continue
            qd = torch.as_tensor(q, device=dev)
            rd = qd if not cross else torch.as_tensor(r, device=dev)
            _, idx = select_batch(qd, rd, k_sel, self_mode=not cross,
                                  nr=[n_refs[i] for i in members],
                                  nq=[ns[i] for i in members])
            pending.append((members, qd, rd, idx))
    cands = [None] * b_true
    for members, q, r, idx in pending:
        idx = idx.cpu().numpy() if torch.is_tensor(idx) else idx
        for b, i in enumerate(members):
            cands[i] = (idx[b, :ns[i]], q[b, :ns[i]],
                        r[b, :n_refs[i]] if cross else q[b, :ns[i]])

    out = np.full((b_true, kmax - 1), np.nan)
    for i, (s, lnl, w) in enumerate(norm):
        stats, sw, rw = whitened[i]
        idx, q32, r32 = cands[i]
        if multi:
            def reselect(ks, _q=sw, _r=rw):
                return sharded_knn_candidates(
                    _q, _r if cross else None, ks, group=layout.ring,
                    engine=engine, device=dev)
        else:
            def reselect(ks, _q=q32, _r=r32):
                return select(_q, _r, ks, self_mode=not cross)[1] \
                    .cpu().numpy()

        dknn = guarded_refine_knn_f64(
            sw, rw if cross else sw, idx, min(kmax, n_refs[i]),
            self_mode=not cross, reselect=reselect)
        sumw = (float(np.sum(w)) if sum_adjusted_weights is None
                else float(sum_adjusted_weights[i]))
        mle = log_evidence_from_knn_np(
            dknn, lnl, w, sumw, ndims[i],
            log_jacobian=stats.log_jacobian,
            log_prior_volume=math.log(prior_volumes[i]),
            k_start=0 if cross else 1, nsamples=s.shape[0])
        # a tiny reference partition fills only its first columns; the rest
        # stay NaN, as on the device path
        out[i, : len(mle) - 1] = mle[1:]
    return out
