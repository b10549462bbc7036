"""kNN candidate selection on the card: kernel wrappers and their plain twins.

Every selection here shares one contract, that of the TPU kernels in
``mcevidence_tpu/ops/knn_pallas.py``:

* inputs: query (Nq, d) and ref (Nr_alloc, d), and a runtime count ``nr``
  (default Nr_alloc) of valid reference rows;
* outputs: d2 (Nq, k) ascending and clamped >= 0, idx (Nq, k) int32, with
  k clipped to Nr_alloc;
* absent slots (fewer than k candidates) hold +inf and -1;
* self mode (query row i is ref row i): slot 0 holds (0, i);
* rows at or past ``nr`` are never selected and stay out of the centring
  mean.

The batched selection (the counterpart of K5,
``knn_select_pallas_packed2_batched``) applies that contract to each member
b of query (B, Nq, d) and ref (B, Nr, d), with per-member counts ``nr[b]``
and ``nq[b]``; query rows at or past ``nq[b]`` come back as absent slots.

``knn_select_torch`` is the plain PyTorch version (the counterpart of
``mcevidence_tpu.ops.knn.knn_select_xla``): the CPU path, the test oracle,
and in float64 the brute-force oracle on the card; ``knn_select_torch_batched``
loops it over the members.  ``knn_select_small_k``, ``knn_select_large_k``
and ``knn_select_batched`` wrap the hand-written kernels of
``csrc/knn_select.cu``; ``knn_select_smalld`` (the counterpart of K8 and K9,
the ``pallas_smalld`` engine) wraps those of ``csrc/knn_smalld.cu``, which
sweep only the d <= 16 true coordinates of an unpadded layout;
``knn_select_packed`` (K6/K7, and K1 as a forced engine) and
``knn_select_prologue`` (the prologue study S1) wrap those of
``csrc/knn_packed.cu``.  ``knn_select_wide`` wraps the kernels of
``csrc/knn_wide.cu`` (a warp-queue body and a list body): one exact (or
truncated-key) selection for any k and any width, where every other
wrapper routes its inputs past the two bodies' limits (k >
``LARGE_K_MAX`` candidates, or d > ``D_MAX`` columns), so the card answers
every shape the JAX package answers.  A wrapper given CPU
tensors returns the plain version; given CUDA tensors it launches its
kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.  Under a span collector (``utils/spans.py``) a
launch of the small-k body also hands the collector its selected query
rows (count ``select_rows``) and a counter on the card that the body adds
the pairs its screen passed to the exact recheck to (count
``select_rechecks``, read once when the collector's block ends).

Every selection centres the rows on the reference rows' masked mean in f32
before it selects, unless it is given ``center=False``: then it takes the
rows as they are, which a caller that has centred a whole chain in f64
uses so that every piece of the chain (a ring's shards) sees the same f32
coordinates.

The exact kernels return exact f32 sums of squared differences as their d2,
so the exact dispatch (``knn_select_cuda``) is also the counterpart of K4,
the exact kernel whose d2 the ``fast`` precision consumes directly.  The
packed selections rank by d2 with its low ``low_bits`` mantissa bits
cleared (ties by the smaller index) and return that truncated d2, as the
TPU's packed kernels do; the plain version does the same with
``low_bits > 0``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..utils.spans import count, device_count

# limits of the two bodies of csrc/knn_common.cuh (knn_select.cu,
# knn_smalld.cu, knn_packed.cu); past them the wrappers take knn_wide.cu
D_MAX = 64
SMALLD_MAX = 16
SMALL_K_MAX = 16
LARGE_K_MAX = 256
# first pass / retry switch of the k-dependent dispatch
# (mcevidence_tpu/ops/knn.py:330: the packed2 kernel below 14, binned above)
LARGE_K_FROM = 14
# mantissa bits the packed selections clear: 11 for K6/K7
# (knn_pallas.py:LOW_BITS), 12 for K1 (two 2048-wide tiles a step)
PACKED_LOW_BITS = (11, 12)
# the prologue study's sentinel reference row (scripts/bench_prologue.py:39)
SENTINEL = 1e18

# bytes one plain-version working buffer may take
_PLAIN_BLOCK_BYTES = 1 << 28
# calls of knn_select_torch on CUDA tensors: the kernels answer every shape
# on the card, so a run that measures them requires 0 (the f64 oracles of
# the tests and chip_smoke.py call it there on purpose)
plain_cuda_calls = 0

Counts = Union[None, int, Sequence[int], torch.Tensor]


def _valid_count(ref: torch.Tensor, nr: Optional[int]) -> int:
    nr = ref.shape[0] if nr is None else int(nr)
    if not 0 <= nr <= ref.shape[0]:
        raise ValueError(f"nr={nr} outside [0, {ref.shape[0]}]")
    return nr


def _masked_mean(ref: torch.Tensor, nr: int) -> torch.Tensor:
    """Centring mean over the valid rows only (``_mu_masked`` semantics)."""
    return ref[:nr].sum(dim=0) / max(nr, 1)


def _truncated_keys(d2: torch.Tensor, low_bits: int) -> torch.Tensor:
    """int64 keys (bits(d2) with the low ``low_bits`` cleared) << 32 | j of
    a (rows, Nr) f32 tile of d2 >= 0: the packed kernels' total order, ties
    by the smaller index."""
    bits = d2.contiguous().view(torch.int32) & ~((1 << low_bits) - 1)
    cols = torch.arange(d2.shape[1], device=d2.device)
    return (bits.to(torch.int64) << 32) | cols


def knn_select_torch(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                     self_mode: bool = False, nr: Optional[int] = None,
                     low_bits: int = 0, center: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN selection in plain PyTorch, in the inputs' dtype.

    Distances are sums of squared differences (no matrix-product identity,
    so duplicates sit at exactly 0), taken over (query chunk, ref block)
    tiles of at most ``_PLAIN_BLOCK_BYTES``; ``torch.topk`` selects.  With
    ``low_bits`` = 0 the selection is exact.  With ``low_bits`` > 0 (f32
    only: the packed selections) it ranks by the int64 key of
    ``_truncated_keys`` and returns the truncated d2: ``topk`` on the
    truncated floats alone would break their many ties in no fixed order.
    """
    nq, d = query.shape
    nr = _valid_count(ref, nr)
    k = min(k, ref.shape[0])
    dtype, dev = query.dtype, query.device
    global plain_cuda_calls
    plain_cuda_calls += dev.type == "cuda"
    if low_bits and dtype != torch.float32:
        raise ValueError(f"low_bits={low_bits} truncates f32 keys, got "
                         f"{dtype}")
    d2_out = torch.full((nq, k), float("inf"), dtype=dtype, device=dev)
    idx_out = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return d2_out, idx_out
    if center:
        mu = _masked_mean(ref, nr)
        q, r = query - mu, ref[:nr] - mu
    else:
        q, r = query, ref[:nr]
    first = 0
    if self_mode:
        d2_out[:, 0] = 0.0
        idx_out[:, 0] = torch.arange(nq, dtype=torch.int32, device=dev)
        first = 1
    keep = min(k - first, nr)
    if keep <= 0:
        return d2_out, idx_out
    elem = max(q.element_size(), 8 if low_bits else 0)
    rows = max(1, min(nq, _PLAIN_BLOCK_BYTES // (max(nr, 1) * elem)))
    cols = max(1, min(nr, _PLAIN_BLOCK_BYTES // (rows * max(d, 1) * elem)))
    for lo in range(0, nq, rows):
        hi = min(nq, lo + rows)
        qc = q[lo:hi]
        d2 = torch.cat([((qc[:, None, :] - r[None, c:c + cols]) ** 2).sum(-1)
                        for c in range(0, nr, cols)], dim=1)
        if self_mode:
            own = torch.arange(lo, hi, device=dev)
            inside = own < nr
            d2[inside.nonzero().squeeze(1), own[inside]] = float("inf")
        if low_bits:
            keys, _ = torch.topk(_truncated_keys(d2, low_bits), keep,
                                 dim=1, largest=False, sorted=True)
            vals = (keys >> 32).to(torch.int32).view(torch.float32)
            pos = keys & 0xFFFFFFFF
        else:
            vals, pos = torch.topk(d2, keep, dim=1, largest=False,
                                   sorted=True)
        pos = torch.where(torch.isinf(vals), -1, pos)
        d2_out[lo:hi, first:first + keep] = vals
        idx_out[lo:hi, first:first + keep] = pos.to(torch.int32)
    return d2_out, idx_out


def _member_counts(counts: Counts, batch: int, alloc: int,
                   name: str) -> list:
    """Per-member counts as host ints, each checked against ``alloc``."""
    if counts is None:
        return [alloc] * batch
    out = [int(c) for c in torch.as_tensor(counts).reshape(-1).tolist()]
    if len(out) != batch:
        raise ValueError(f"{name} has {len(out)} entries for a batch of "
                         f"{batch}")
    for c in out:
        if not 0 <= c <= alloc:
            raise ValueError(f"{name}={c} outside [0, {alloc}]")
    return out


def knn_select_torch_batched(query: torch.Tensor, ref: torch.Tensor, k: int,
                             *, self_mode: bool = False, nr: Counts = None,
                             nq: Counts = None, low_bits: int = 0,
                             center: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched selection in plain PyTorch: ``knn_select_torch`` (with
    ``low_bits``) on each member's first ``nq[b]`` query rows against its
    first ``nr[b]`` reference rows.  Returns (B, Nq, k) d2 and idx, k
    clipped to Nr."""
    _check_batched(query, ref, self_mode)
    bsz, nq_alloc, _ = query.shape
    nr_b = _member_counts(nr, bsz, ref.shape[1], "nr")
    nq_b = _member_counts(nq, bsz, nq_alloc, "nq")
    k = min(k, ref.shape[1])
    d2 = torch.full((bsz, nq_alloc, k), float("inf"), dtype=query.dtype,
                    device=query.device)
    idx = torch.full((bsz, nq_alloc, k), -1, dtype=torch.int32,
                     device=query.device)
    for b in range(bsz):
        d2[b, :nq_b[b]], idx[b, :nq_b[b]] = knn_select_torch(
            query[b, :nq_b[b]], ref[b], k, self_mode=self_mode, nr=nr_b[b],
            low_bits=low_bits, center=center)
    return d2, idx


def _check_inputs(query: torch.Tensor, ref: torch.Tensor) -> None:
    if query.device != ref.device:
        raise ValueError(f"query on {query.device} but ref on {ref.device}")
    if query.dim() != 2 or ref.dim() != 2 or query.shape[1] != ref.shape[1]:
        raise ValueError(f"expected (Nq, d) and (Nr, d), got "
                         f"{tuple(query.shape)} and {tuple(ref.shape)}")
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {query.device}")


def _check_batched(query: torch.Tensor, ref: torch.Tensor,
                   self_mode: bool) -> None:
    if query.device != ref.device:
        raise ValueError(f"query on {query.device} but ref on {ref.device}")
    if (query.dim() != 3 or ref.dim() != 3 or query.shape[0] != ref.shape[0]
            or query.shape[2] != ref.shape[2]):
        raise ValueError(f"expected (B, Nq, d) and (B, Nr, d), got "
                         f"{tuple(query.shape)} and {tuple(ref.shape)}")
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {query.device}")
    if self_mode and query.shape[1] > ref.shape[1]:
        raise ValueError("self mode needs every query row to be a ref row")


def _padded_width(d: int) -> int:
    """The ``Padded`` width of d columns (8, 16, 32 or 64); raises past
    ``D_MAX`` (the dispatch sends such rows to ``knn_select_wide`` first)."""
    for dp in (8, 16, 32, 64):
        if d <= dp:
            return dp
    raise ValueError(f"the Padded layouts take d <= {D_MAX}, got d={d}")


def _past_limits(d: int, k: int) -> bool:
    """Whether d columns or k candidates lie past the two bodies' limits."""
    return d > D_MAX or k > LARGE_K_MAX


def _call(entry: str, q, r, d2, idx, *, batch, q_rows, r_rows, nq_dev,
          nr_dev, nr_all, dp, k, self_mode, extra=(), rows=0) -> None:
    """Call one C entry point of ``csrc/`` on the current stream (``dp``:
    the rows' width as laid out, padded or not; ``extra``: the arguments an
    entry point of ``ENTRY_POINTS_EXTRA`` or ``ENTRY_POINTS_WIDE`` takes
    after ``device``); raises on a non-zero cudaError_t.  An entry point of
    ``ENTRY_POINTS_SMALL_K`` also gets ``_rechecks``' counter, with
    ``rows`` the valid query rows it selects for."""
    from . import _build
    dev = q.device
    lib = _build.load_entry(entry)
    args = [q.data_ptr(), r.data_ptr(), batch, q_rows, r_rows,
            None if nq_dev is None else nq_dev.data_ptr(),
            None if nr_dev is None else nr_dev.data_ptr(), nr_all, dp, k,
            int(self_mode), d2.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0,
            *extra]
    if entry in _build.ENTRY_POINTS_SMALL_K:
        counter = _rechecks(dev, rows)
        args.append(None if counter is None else counter.data_ptr())
    code = getattr(lib, entry)(*args)
    _build.check(lib, code, entry)


def _rechecks(dev, rows: int):
    """The counter a small-k launch adds its exact rechecks to under an
    active span collector (``utils/spans.py``: read once, when the
    collector's block ends, as the count ``select_rechecks``), with the
    launch's ``rows`` counted as ``select_rows``; None with no
    collector."""
    counter = device_count("select_rechecks", dev)
    if counter is not None:
        count("select_rows", rows)
    return counter


def _centred(query, ref, nr, dp, self_mode, center):
    """f32 query (Nq, dp) and reference (nr, dp) rows, each centred on the
    reference rows' masked mean when ``center`` and zero-padded from d to
    ``dp`` columns."""
    nq, d = query.shape
    dev = query.device
    mu = _masked_mean(ref.to(torch.float32), nr) if center else 0.0
    q = torch.zeros((nq, dp), dtype=torch.float32, device=dev)
    q[:, :d] = query.to(torch.float32) - mu
    if self_mode and ref is query:
        return q, q
    r = torch.zeros((nr, dp), dtype=torch.float32, device=dev)
    r[:, :d] = ref[:nr].to(torch.float32) - mu
    return q, r


def _centred_batched(query, ref, nr_dev, dp, self_mode, center):
    """``_centred`` per member of (B, N, d) rows, each on its own masked
    mean: rows at or past nr[b] may hold anything, so they are selected out,
    not multiplied by zero."""
    d = query.shape[2]
    dev = query.device
    ref32 = ref.to(torch.float32)
    mu = 0.0
    if center:
        ok = (torch.arange(ref.shape[1], device=dev)[None, :]
              < nr_dev[:, None])
        mu = (torch.where(ok[..., None], ref32, 0.0).sum(dim=1)
              / nr_dev.clamp(min=1)[:, None].to(torch.float32))[:, None, :]
    q = torch.zeros(query.shape[:2] + (dp,), dtype=torch.float32, device=dev)
    q[..., :d] = query.to(torch.float32) - mu
    if self_mode and ref is query:
        return q, q
    r = torch.zeros(ref.shape[:2] + (dp,), dtype=torch.float32, device=dev)
    r[..., :d] = ref32 - mu
    return q, r


def _launch(entry: str, query, ref, k, self_mode, nr, dp=None, extra=(),
            center=True):
    """Centre (unless ``center`` is False), pad d to the kernel width ``dp``
    (default the next of 8/16/32/64), allocate the outputs and launch the
    kernel as a batch of one member."""
    nq, d = query.shape
    dp = _padded_width(d) if dp is None else dp
    nr = _valid_count(ref, nr)
    k = min(k, ref.shape[0])
    if self_mode and nq > ref.shape[0]:
        raise ValueError("self mode needs every query row to be a ref row")
    dev = query.device
    q, r = _centred(query, ref, nr, dp, self_mode, center)
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return d2, idx, False
    _call(entry, q, r, d2, idx, batch=1, q_rows=nq, r_rows=nr, nq_dev=None,
          nr_dev=None, nr_all=nr, dp=dp, k=k, self_mode=self_mode,
          extra=extra, rows=nq)
    return d2, idx, True


def knn_select_small_k(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                       self_mode: bool = False, nr: Optional[int] = None,
                       center: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Small-k selection (k <= 16): the counterpart of the TPU kernel K1
    (``knn_select_pallas_packed2``).  The small-k body of
    ``csrc/knn_common.cuh``: each thread holds its query rows' sorted top-k
    in registers, two threads share a query row, a pair is screened by one
    FMA a coordinate and only the pairs the screen passes are recomputed by
    differences; exact.  Rows wider than ``D_MAX`` take
    ``knn_select_wide``."""
    _check_inputs(query, ref)
    if query.device.type == "cpu":
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr,
                                center=center)
    if min(k, ref.shape[0]) > SMALL_K_MAX:
        raise ValueError(f"knn_select_small_k takes k <= {SMALL_K_MAX}, "
                         f"got k={k}")
    if _past_limits(query.shape[1], k):
        return knn_select_wide(query, ref, k, self_mode=self_mode, nr=nr,
                               center=center)
    d2, idx, launched = _launch("knn_select_small_k", query, ref, k,
                                self_mode, nr, center=center)
    knn_select_small_k.launches += launched
    return d2, idx


def knn_select_large_k(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                       self_mode: bool = False, nr: Optional[int] = None,
                       center: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Large-k selection: the counterpart of the TPU kernels K2 and K3
    (``knn_select_pallas_binned``).  The large-k body of
    ``csrc/knn_common.cuh`` up to k = ``LARGE_K_MAX``: WarpSelect, a warp
    queue of the k smallest keys sorted across a warp's registers, short
    thread queues merged by bitonic shuffle networks; exact, with no cap on
    the reference rows.  More candidates, or rows wider than ``D_MAX``,
    take ``knn_select_wide``."""
    _check_inputs(query, ref)
    if query.device.type == "cpu":
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr,
                                center=center)
    if _past_limits(query.shape[1], min(k, ref.shape[0])):
        return knn_select_wide(query, ref, k, self_mode=self_mode, nr=nr,
                               center=center)
    d2, idx, launched = _launch("knn_select_large_k", query, ref, k,
                                self_mode, nr, center=center)
    knn_select_large_k.launches += launched
    return d2, idx


def _launch_batched(small_entry: str, large_entry: str, query, ref, k,
                    self_mode, nr, nq, dp, extra=(), center=True):
    """Centre each member on its masked mean (f32, unless ``center`` is
    False), pad d to ``dp``, and launch the small-k body below
    ``LARGE_K_FROM`` candidates and the large-k body from there (k <=
    ``LARGE_K_MAX``: the wrappers send more to ``knn_select_wide``), once
    over the whole batch, with the per-member counts in int32 arrays on the
    card."""
    bsz, nq_alloc, _ = query.shape
    nr_alloc = ref.shape[1]
    k = min(k, nr_alloc)
    nr_b = _member_counts(nr, bsz, nr_alloc, "nr")
    nq_b = _member_counts(nq, bsz, nq_alloc, "nq")
    dev = query.device
    d2 = torch.empty((bsz, nq_alloc, k), dtype=torch.float32, device=dev)
    idx = torch.empty((bsz, nq_alloc, k), dtype=torch.int32, device=dev)
    if bsz == 0 or nq_alloc == 0 or k == 0:
        return d2, idx, False
    nr_dev = torch.tensor(nr_b, dtype=torch.int32, device=dev)
    nq_dev = torch.tensor(nq_b, dtype=torch.int32, device=dev)
    q, r = _centred_batched(query, ref, nr_dev, dp, self_mode, center)
    entry = large_entry if k >= LARGE_K_FROM else small_entry
    _call(entry, q, r, d2, idx, batch=bsz, q_rows=nq_alloc, r_rows=nr_alloc,
          nq_dev=nq_dev, nr_dev=nr_dev, nr_all=nr_alloc, dp=dp, k=k,
          self_mode=self_mode, extra=extra, rows=sum(nq_b))
    return d2, idx, True


def knn_select_batched(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                       self_mode: bool = False, nr: Counts = None,
                       nq: Counts = None, center: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched selection, the counterpart of the TPU kernel K5
    (``knn_select_pallas_packed2_batched``): one launch over query
    (B, Nq, d) and ref (B, Nr, d) with per-member counts ``nr`` and ``nq``
    (sequences of B ints; default Nr and Nq).  The small-k kernel body runs
    below ``LARGE_K_FROM`` candidates and the large-k body from there, each
    with the batch member on the grid's y axis and the counts read from
    int32 arrays on the card; past ``LARGE_K_MAX`` candidates or ``D_MAX``
    columns, ``knn_select_wide``'s batched form.  Returns (B, Nq, k) d2 and
    idx."""
    _check_batched(query, ref, self_mode)
    if query.device.type == "cpu":
        return knn_select_torch_batched(query, ref, k, self_mode=self_mode,
                                        nr=nr, nq=nq, center=center)
    if _past_limits(query.shape[2], min(k, ref.shape[1])):
        return knn_select_wide(query, ref, k, self_mode=self_mode, nr=nr,
                               nq=nq, center=center)
    d2, idx, launched = _launch_batched(
        "knn_select_small_k", "knn_select_large_k", query, ref, k, self_mode,
        nr, nq, _padded_width(query.shape[2]), center=center)
    knn_select_batched.launches += launched
    return d2, idx


def knn_select_smalld(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                      self_mode: bool = False, nr: Counts = None,
                      nq: Counts = None, center: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Small-d selection, the counterpart of the TPU kernels K8
    (``knn_select_pallas_smalld``) and K9
    (``knn_select_pallas_smalld_batched``): the ``pallas_smalld`` engine.

    Takes query (Nq, d) and ref (Nr, d) with a host count ``nr``, or query
    (B, Nq, d) and ref (B, Nr, d) with per-member counts ``nr`` and ``nq``,
    for 1 <= d <= ``SMALLD_MAX``.  The rows go to the kernel unpadded, and
    it sums exactly d squared differences per pair (every coordinate it is
    given: a batch of mixed widths sweeps its widest).  The small-k body
    runs below ``LARGE_K_FROM`` candidates and the large-k body from there
    up to ``LARGE_K_MAX``; more candidates take ``knn_select_wide``, which
    also sweeps the d true coordinates.  Exact, so it meets K8's and K9's
    <= 2^-12 quantisation contract."""
    batched = query.dim() == 3
    if batched:
        _check_batched(query, ref, self_mode)
    else:
        _check_inputs(query, ref)
        if nq is not None:
            raise ValueError("nq is a per-member count of the batched form")
    if query.device.type == "cpu":
        if batched:
            return knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr, nq=nq,
                                            center=center)
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr,
                                center=center)
    d = query.shape[-1]
    if not 1 <= d <= SMALLD_MAX:
        raise ValueError(f"knn_select_smalld takes 1 <= d <= {SMALLD_MAX}, "
                         f"got d={d}")
    if min(k, ref.shape[-2]) > LARGE_K_MAX:
        return knn_select_wide(query, ref, k, self_mode=self_mode, nr=nr,
                               nq=nq, center=center)
    if batched:
        d2, idx, launched = _launch_batched(
            "knn_select_smalld_small_k", "knn_select_smalld_large_k", query,
            ref, k, self_mode, nr, nq, d, center=center)
    else:
        entry = ("knn_select_smalld_large_k" if k >= LARGE_K_FROM
                 else "knn_select_smalld_small_k")
        d2, idx, launched = _launch(entry, query, ref, k, self_mode, nr,
                                    dp=d, center=center)
    knn_select_smalld.launches += launched
    return d2, idx


def knn_select_packed(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                      low_bits: int = 11, self_mode: bool = False,
                      nr: Counts = None, nq: Counts = None,
                      center: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed selection: the counterpart of the TPU kernels K6
    (``knn_select_pallas_packed``) and K7
    (``knn_select_pallas_packed_batched``) at ``low_bits`` = 11, and of K1
    (``knn_select_pallas_packed2``) as a forced engine at ``low_bits`` = 12.

    Takes query (Nq, d) and ref (Nr, d) with a host count ``nr``, or query
    (B, Nq, d) and ref (B, Nr, d) with per-member counts ``nr`` and ``nq``.
    Ranks the candidates by d2 with its low ``low_bits`` mantissa bits
    cleared, ties by the smaller index, and returns that truncated d2 (at
    most 2^(low_bits - 23) below the exact value), as the TPU kernels do.
    The small-k body runs below ``LARGE_K_FROM`` candidates and the large-k
    body from there up to ``LARGE_K_MAX``; more candidates, or rows wider
    than ``D_MAX``, take ``knn_select_wide`` with the same truncation."""
    if low_bits not in PACKED_LOW_BITS:
        raise ValueError(f"low_bits must be one of {PACKED_LOW_BITS}, got "
                         f"{low_bits}")
    batched = query.dim() == 3
    if batched:
        _check_batched(query, ref, self_mode)
    else:
        _check_inputs(query, ref)
        if nq is not None:
            raise ValueError("nq is a per-member count of the batched form")
    if query.device.type == "cpu":
        if batched:
            return knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr, nq=nq,
                                            low_bits=low_bits, center=center)
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr,
                                low_bits=low_bits, center=center)
    if _past_limits(query.shape[-1], min(k, ref.shape[-2])):
        return knn_select_wide(query, ref, k, self_mode=self_mode, nr=nr,
                               nq=nq, low_bits=low_bits, center=center)
    if batched:
        d2, idx, launched = _launch_batched(
            "knn_select_packed_small_k", "knn_select_packed_large_k", query,
            ref, k, self_mode, nr, nq, _padded_width(query.shape[2]),
            extra=(low_bits,), center=center)
    else:
        entry = ("knn_select_packed_large_k" if k >= LARGE_K_FROM
                 else "knn_select_packed_small_k")
        d2, idx, launched = _launch(entry, query, ref, k, self_mode, nr,
                                    extra=(low_bits,), center=center)
    knn_select_packed.launches += launched
    return d2, idx


# the wide kernels' layouts (csrc/knn_wide.cu).  Route A, the warp-queue
# body: exact keys, d <= D_MAX, at most WARP_QUEUE_MAX kept keys, in a warp
# queue of 16 or 32 keys a lane.  Route B, the list body:
# LIST_QUERIES query rows a warp, lists of at least LIST_MIN_KEYS keys, up
# to LIST_MAX_WARPS warps a block, two stages of a 256-row by 32-coordinate
# tile, and the shared memory a block may take.
WARP_QUEUE_MAX = 1024
LIST_QUERIES = 2
LIST_MIN_KEYS = 64
LIST_MAX_WARPS = 16
_LIST_STAGE_FLOATS = 2 * 32 * (256 + 1)
_WIDE_SHARED_MAX = 227 * 1024
# bytes of the global lists one launch may use when they leave shared memory
_WIDE_WORKSPACE_BYTES = 1 << 28


class WidePlan(NamedTuple):
    """How ``knn_select_wide`` launches: ``route`` "A" (the warp-queue
    body) or "B" (the list body); ``width`` the columns the rows are laid
    out in (A: the ``Padded`` width, B: d); ``kp`` the keys a row keeps
    (A: the warp queue's, 32 for each key a lane holds; B: a list's);
    ``warps`` B's warps a block (0 for A, whose body fixes them);
    ``workspace`` whether B's lists go to a global workspace."""
    route: str
    width: int
    kp: int
    warps: int
    workspace: bool


def _list_shared_bytes(d: int, kp: int, warps: int, workspace: bool) -> int:
    keys = 0 if workspace else warps * LIST_QUERIES * 2 * kp * 8
    query = warps * LIST_QUERIES * (-(-d // 4) * 4)
    return keys + (_LIST_STAGE_FLOATS + query) * 4


def wide_plan(d: int, keep: int, low_bits: int = 0,
              route: Optional[str] = None) -> WidePlan:
    """The wide selection's launch for rows of d columns, ``keep`` kept
    keys a query row (k less the self slot) and ``low_bits``.

    Route A takes exact keys at d <= ``D_MAX`` and keep <=
    ``WARP_QUEUE_MAX``: 16 keys a lane to 512 keys, else 32.  Route B takes
    the rest (``route="B"`` forces it, for the tests that hold the two
    routes to each other): kp is ``keep`` rounded up to a power of two (at
    least ``LIST_MIN_KEYS``), with the most warps (16, 8, 4, 2, 1) whose
    lists, tiles and staged query rows fit a block's shared memory; where
    not even one warp's lists fit, the lists go to a global workspace."""
    keep = max(keep, 1)
    if (route != "B" and low_bits == 0 and d <= D_MAX
            and keep <= WARP_QUEUE_MAX):
        dp = _padded_width(d)
        n = 16 if keep <= 512 else 32
        return WidePlan("A", dp, 32 * n, 0, False)
    kp = LIST_MIN_KEYS
    while kp < keep:
        kp *= 2
    for workspace in (False, True):
        warps = LIST_MAX_WARPS
        while warps >= 1:
            if _list_shared_bytes(d, kp, warps, workspace) <= _WIDE_SHARED_MAX:
                return WidePlan("B", d, kp, warps, workspace)
            warps //= 2
    raise ValueError(f"rows of d={d} columns are too wide for the wide "
                     f"selection's staged query rows")


def knn_select_wide(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                    self_mode: bool = False, nr: Counts = None,
                    nq: Counts = None, low_bits: int = 0,
                    center: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wide selection, the kernels of ``csrc/knn_wide.cu``: any k and any
    width d, 2-D (query (Nq, d), ref (Nr, d), host count ``nr``) or batched
    ((B, Nq, d), (B, Nr, d), per-member ``nr`` and ``nq``).  ``low_bits`` 0
    ranks exactly; 11 or 12 rank by the packed selections' truncated keys
    and return the truncated d2.  ``wide_plan`` picks the route: exact keys
    at d <= ``D_MAX`` and up to ``WARP_QUEUE_MAX`` kept keys take the
    warp-queue body (WarpSelect with 16 or 32 keys a lane, rows padded to
    the ``Padded`` width); the rest take the list body (rows of exactly d
    columns, a sorted list and a buffer a query row; lists that do not fit
    shared memory live in a global workspace, with the query rows launched
    in chunks that keep it within ``_WIDE_WORKSPACE_BYTES``).  Both routes
    return the same bits.  Its plain version is ``knn_select_torch`` /
    ``knn_select_torch_batched`` with the same ``low_bits``."""
    if low_bits not in (0,) + PACKED_LOW_BITS:
        raise ValueError(f"low_bits must be 0 or one of {PACKED_LOW_BITS}, "
                         f"got {low_bits}")
    batched = query.dim() == 3
    if batched:
        _check_batched(query, ref, self_mode)
    else:
        _check_inputs(query, ref)
        if nq is not None:
            raise ValueError("nq is a per-member count of the batched form")
        if self_mode and query.shape[0] > ref.shape[0]:
            raise ValueError("self mode needs every query row to be a ref "
                             "row")
    if query.device.type == "cpu":
        if batched:
            return knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr, nq=nq,
                                            low_bits=low_bits, center=center)
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr,
                                low_bits=low_bits, center=center)
    return _launch_wide(query, ref, k, self_mode, nr, nq, low_bits, center)


def _launch_wide(query, ref, k, self_mode, nr, nq, low_bits, center,
                 route=None):
    """``knn_select_wide`` on checked CUDA tensors; ``route`` "B" forces
    the list body."""
    dev = query.device
    d = query.shape[-1]
    nr_alloc = ref.shape[-2]
    k = min(k, nr_alloc)
    plan = wide_plan(d, k - int(self_mode), low_bits, route)
    if query.dim() == 3:
        bsz, nq_alloc, _ = query.shape
        nr_dev = torch.tensor(_member_counts(nr, bsz, nr_alloc, "nr"),
                              dtype=torch.int32, device=dev)
        nq_dev = torch.tensor(_member_counts(nq, bsz, nq_alloc, "nq"),
                              dtype=torch.int32, device=dev)
        q, r = _centred_batched(query, ref, nr_dev, plan.width, self_mode,
                                center)
        r_rows = nr_all = nr_alloc
        shape = (bsz, nq_alloc, k)
    else:
        bsz, nq_alloc = 1, query.shape[0]
        nr_all = _valid_count(ref, nr)
        nq_dev = nr_dev = None
        q, r = _centred(query, ref, nr_all, plan.width, self_mode, center)
        r_rows = nr_all
        shape = (nq_alloc, k)
    d2 = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    if bsz == 0 or nq_alloc == 0 or k == 0:
        return d2, idx
    chunk, work = nq_alloc, None
    if plan.workspace:
        rows = plan.warps * LIST_QUERIES
        chunk = max(rows, _WIDE_WORKSPACE_BYTES // (bsz * 16 * plan.kp)
                    // rows * rows)
        work = torch.empty((bsz, min(chunk, nq_alloc), 2 * plan.kp),
                           dtype=torch.int64, device=dev)
    for row0 in range(0, nq_alloc, chunk):
        row1 = min(nq_alloc, row0 + chunk)
        _call("knn_select_wide", q, r, d2, idx, batch=bsz, q_rows=nq_alloc,
              r_rows=r_rows, nq_dev=nq_dev, nr_dev=nr_dev, nr_all=nr_all,
              dp=plan.width, k=k, self_mode=self_mode,
              extra=(low_bits, "AB".index(plan.route), plan.kp, plan.warps,
                     row0, row1, None if work is None else work.data_ptr()))
        knn_select_wide.launches += 1
    return d2, idx


# the prologue study's variants and their cuts (csrc/knn_packed.cu)
PROLOGUE_CUTS = {"B": 1, "BC": 3}


def knn_select_prologue_torch(query: torch.Tensor, ref: torch.Tensor,
                              k: int, *, self_mode: bool = True,
                              nr: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prologue study's function in plain PyTorch: K1's packed
    selection at 12 low bits, with slots whose d2 > 1e30 absent (a sentinel
    row's, scripts/bench_prologue.py:152-154)."""
    d2, idx = knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr,
                               low_bits=12)
    far = d2 > 1e30
    return d2.masked_fill(far, float("inf")), idx.masked_fill(far, -1)


def knn_select_prologue(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                        variant: str = "B", self_mode: bool = True,
                        nr: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prologue study S1 (``scripts/bench_prologue.py:_kernel``): K1's
    function (12 low bits, small-k body, k - self_mode <= ``SMALL_K_MAX``)
    with the prologue cut.  ``variant`` "B": the reference allocation is
    padded to a multiple of 128 rows with sentinel rows (``SENTINEL`` in
    every column) in place of the per-tile count bound; "BC": also the self
    test only in the tile that holds the block's own rows.  Cut A (one wide
    matrix product) has no counterpart: the kernels take distances by
    differences."""
    if variant not in PROLOGUE_CUTS:
        raise ValueError(f"variant must be one of {sorted(PROLOGUE_CUTS)}, "
                         f"got {variant!r}")
    _check_inputs(query, ref)
    if query.device.type == "cpu":
        return knn_select_prologue_torch(query, ref, k, self_mode=self_mode,
                                         nr=nr)
    nq, d = query.shape
    nr = _valid_count(ref, nr)
    k = min(k, ref.shape[0])
    if k - int(self_mode) > SMALL_K_MAX:
        raise ValueError(f"knn_select_prologue takes k - self_mode <= "
                         f"{SMALL_K_MAX}, got k={k}")
    if self_mode and nq > ref.shape[0]:
        raise ValueError("self mode needs every query row to be a ref row")
    dp = _padded_width(d)
    dev = query.device
    tile = 128                    # kTile of csrc/knn_common.cuh
    nr_pad = -(-max(nr, 1) // tile) * tile
    mu = _masked_mean(ref.to(torch.float32), nr)
    r = torch.full((nr_pad, dp), SENTINEL, dtype=torch.float32, device=dev)
    r[:nr] = 0.0
    r[:nr, :d] = ref[:nr].to(torch.float32) - mu
    if self_mode and ref is query and nq <= nr:
        q = r[:nq]
    else:
        q = torch.zeros((nq, dp), dtype=torch.float32, device=dev)
        q[:, :d] = query.to(torch.float32) - mu
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return d2, idx
    _call("knn_select_prologue", q, r, d2, idx, batch=1, q_rows=nq,
          r_rows=nr_pad, nq_dev=None, nr_dev=None, nr_all=nr_pad, dp=dp, k=k,
          self_mode=self_mode, extra=(PROLOGUE_CUTS[variant],), rows=nq)
    knn_select_prologue.launches += 1
    return d2, idx


KERNEL_WRAPPERS = (knn_select_small_k, knn_select_large_k, knn_select_batched,
                   knn_select_smalld, knn_select_packed, knn_select_prologue,
                   knn_select_wide)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0


def knn_select_cuda(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                    self_mode: bool = False, nr: Optional[int] = None,
                    center: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact k-dependent dispatch: small-k kernel below
    ``LARGE_K_FROM`` candidates, large-k kernel from there, the wide kernel
    past ``LARGE_K_MAX`` candidates or ``D_MAX`` columns.  The selection of
    the refine and device paths, and the counterpart of K4 where the
    ``fast`` precision uses the returned d2 directly."""
    sel = knn_select_large_k if k >= LARGE_K_FROM else knn_select_small_k
    return sel(query, ref, k, self_mode=self_mode, nr=nr, center=center)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count, and the plain selection's
    count of calls on CUDA tensors, to 0."""
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0
    global plain_cuda_calls
    plain_cuda_calls = 0
