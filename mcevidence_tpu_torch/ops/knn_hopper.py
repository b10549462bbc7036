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
sweep only the d <= 16 true coordinates of an unpadded layout.  A wrapper
given CPU tensors returns the plain version; given CUDA tensors it launches
its kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.

Every kernel returns exact f32 sums of squared differences as its d2, so
the exact dispatch (``knn_select_cuda``) is also the counterpart of K4, the
exact kernel whose d2 the ``fast`` precision consumes directly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

# limits of the hand-written kernels (csrc/knn_select.cu, csrc/knn_smalld.cu)
D_MAX = 64
SMALLD_MAX = 16
SMALL_K_MAX = 16
LARGE_K_MAX = 256
# first pass / retry switch of the k-dependent dispatch
# (mcevidence_tpu/ops/knn.py:330: the packed2 kernel below 14, binned above)
LARGE_K_FROM = 14

# bytes one plain-version working buffer may take
_PLAIN_BLOCK_BYTES = 1 << 28

Counts = Union[None, int, Sequence[int], torch.Tensor]


def _valid_count(ref: torch.Tensor, nr: Optional[int]) -> int:
    nr = ref.shape[0] if nr is None else int(nr)
    if not 0 <= nr <= ref.shape[0]:
        raise ValueError(f"nr={nr} outside [0, {ref.shape[0]}]")
    return nr


def _masked_mean(ref: torch.Tensor, nr: int) -> torch.Tensor:
    """Centring mean over the valid rows only (``_mu_masked`` semantics)."""
    return ref[:nr].sum(dim=0) / max(nr, 1)


def knn_select_torch(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                     self_mode: bool = False, nr: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN selection in plain PyTorch, in the inputs' dtype.

    Distances are sums of squared differences (no matrix-product identity,
    so duplicates sit at exactly 0), taken over (query chunk, ref block)
    tiles of at most ``_PLAIN_BLOCK_BYTES``; ``torch.topk`` selects.
    """
    nq, d = query.shape
    nr = _valid_count(ref, nr)
    k = min(k, ref.shape[0])
    dtype, dev = query.dtype, query.device
    d2_out = torch.full((nq, k), float("inf"), dtype=dtype, device=dev)
    idx_out = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return d2_out, idx_out
    mu = _masked_mean(ref, nr)
    q = query - mu
    r = ref[:nr] - mu
    first = 0
    if self_mode:
        d2_out[:, 0] = 0.0
        idx_out[:, 0] = torch.arange(nq, dtype=torch.int32, device=dev)
        first = 1
    keep = min(k - first, nr)
    if keep <= 0:
        return d2_out, idx_out
    elem = q.element_size()
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
        vals, pos = torch.topk(d2, keep, dim=1, largest=False, sorted=True)
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
                             nq: Counts = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched selection in plain PyTorch: ``knn_select_torch`` on each
    member's first ``nq[b]`` query rows against its first ``nr[b]``
    reference rows.  Returns (B, Nq, k) d2 and idx, k clipped to Nr."""
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
            query[b, :nq_b[b]], ref[b], k, self_mode=self_mode, nr=nr_b[b])
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
    for dp in (8, 16, 32, 64):
        if d <= dp:
            return dp
    raise ValueError(f"the CUDA kNN kernels take d <= {D_MAX}, got d={d}")


def _call(entry: str, q, r, d2, idx, *, batch, q_rows, r_rows, nq_dev,
          nr_dev, nr_all, dp, k, self_mode) -> None:
    """Call one C entry point of ``csrc/`` on the current stream (``dp``:
    the rows' width as laid out, padded or not); raises on a non-zero
    cudaError_t."""
    from . import _build
    dev = q.device
    lib = _build.load()
    code = getattr(lib, entry)(
        q.data_ptr(), r.data_ptr(), batch, q_rows, r_rows,
        None if nq_dev is None else nq_dev.data_ptr(),
        None if nr_dev is None else nr_dev.data_ptr(), nr_all, dp, k,
        int(self_mode), d2.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    _build.check(lib, code, entry)


def _launch(entry: str, query, ref, k, self_mode, nr, dp=None):
    """Centre (masked mean, f32), pad d to the kernel width ``dp`` (default
    the next of 8/16/32/64), allocate the outputs and launch the kernel as a
    batch of one member."""
    nq, d = query.shape
    dp = _padded_width(d) if dp is None else dp
    nr = _valid_count(ref, nr)
    k = min(k, ref.shape[0])
    if self_mode and nq > ref.shape[0]:
        raise ValueError("self mode needs every query row to be a ref row")
    dev = query.device
    mu = _masked_mean(ref.to(torch.float32), nr)
    q = torch.zeros((nq, dp), dtype=torch.float32, device=dev)
    q[:, :d] = query.to(torch.float32) - mu
    if self_mode and ref is query:
        r = q
    else:
        r = torch.zeros((nr, dp), dtype=torch.float32, device=dev)
        r[:, :d] = ref[:nr].to(torch.float32) - mu
    d2 = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return d2, idx, False
    _call(entry, q, r, d2, idx, batch=1, q_rows=nq, r_rows=nr, nq_dev=None,
          nr_dev=None, nr_all=nr, dp=dp, k=k, self_mode=self_mode)
    return d2, idx, True


def knn_select_small_k(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                       self_mode: bool = False, nr: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Small-k selection (k <= 16): the counterpart of the TPU kernel K1
    (``knn_select_pallas_packed2``).  One thread per query row, sorted
    top-k in registers; exact."""
    _check_inputs(query, ref)
    if query.device.type == "cpu":
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr)
    if min(k, ref.shape[0]) > SMALL_K_MAX:
        raise ValueError(f"knn_select_small_k takes k <= {SMALL_K_MAX}, "
                         f"got k={k}")
    d2, idx, launched = _launch("knn_select_small_k", query, ref, k,
                                self_mode, nr)
    knn_select_small_k.launches += launched
    return d2, idx


def knn_select_large_k(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                       self_mode: bool = False, nr: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Large-k selection (k <= 256): the counterpart of the TPU kernels K2
    and K3 (``knn_select_pallas_binned``).  One warp per query row, a
    depth-k sorted list per lane in shared memory, a shuffle merge; exact,
    with no cap on the reference rows."""
    _check_inputs(query, ref)
    if query.device.type == "cpu":
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr)
    if min(k, ref.shape[0]) > LARGE_K_MAX:
        raise ValueError(f"knn_select_large_k takes k <= {LARGE_K_MAX}, "
                         f"got k={k}")
    d2, idx, launched = _launch("knn_select_large_k", query, ref, k,
                                self_mode, nr)
    knn_select_large_k.launches += launched
    return d2, idx


def _launch_batched(small_entry: str, large_entry: str, query, ref, k,
                    self_mode, nr, nq, dp):
    """Centre each member on its masked mean (f32), pad d to ``dp``, and
    launch the small-k body below ``LARGE_K_FROM`` candidates and the
    large-k body from there, once over the whole batch, with the per-member
    counts in int32 arrays on the card."""
    bsz, nq_alloc, d = query.shape
    nr_alloc = ref.shape[1]
    k = min(k, nr_alloc)
    if k > LARGE_K_MAX:
        raise ValueError(f"the batched kernels take k <= {LARGE_K_MAX}, "
                         f"got k={k}")
    nr_b = _member_counts(nr, bsz, nr_alloc, "nr")
    nq_b = _member_counts(nq, bsz, nq_alloc, "nq")
    dev = query.device
    d2 = torch.empty((bsz, nq_alloc, k), dtype=torch.float32, device=dev)
    idx = torch.empty((bsz, nq_alloc, k), dtype=torch.int32, device=dev)
    if bsz == 0 or nq_alloc == 0 or k == 0:
        return d2, idx, False
    nr_dev = torch.tensor(nr_b, dtype=torch.int32, device=dev)
    nq_dev = torch.tensor(nq_b, dtype=torch.int32, device=dev)
    # per-member masked mean (``_mu_masked``): rows at or past nr[b] may hold
    # anything, so they are selected out, not multiplied by zero
    ref32 = ref.to(torch.float32)
    ok = (torch.arange(nr_alloc, device=dev)[None, :] < nr_dev[:, None])
    mu = (torch.where(ok[..., None], ref32, 0.0).sum(dim=1)
          / nr_dev.clamp(min=1)[:, None].to(torch.float32))[:, None, :]
    q = torch.zeros((bsz, nq_alloc, dp), dtype=torch.float32, device=dev)
    q[..., :d] = query.to(torch.float32) - mu
    if self_mode and ref is query:
        r = q
    else:
        r = torch.zeros((bsz, nr_alloc, dp), dtype=torch.float32, device=dev)
        r[..., :d] = ref32 - mu
    entry = large_entry if k >= LARGE_K_FROM else small_entry
    _call(entry, q, r, d2, idx, batch=bsz, q_rows=nq_alloc, r_rows=nr_alloc,
          nq_dev=nq_dev, nr_dev=nr_dev, nr_all=nr_alloc, dp=dp, k=k,
          self_mode=self_mode)
    return d2, idx, True


def knn_select_batched(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                       self_mode: bool = False, nr: Counts = None,
                       nq: Counts = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched selection, the counterpart of the TPU kernel K5
    (``knn_select_pallas_packed2_batched``): one launch over query
    (B, Nq, d) and ref (B, Nr, d) with per-member counts ``nr`` and ``nq``
    (sequences of B ints; default Nr and Nq).  The small-k kernel body runs
    below ``LARGE_K_FROM`` candidates and the large-k body from there, each
    with the batch member on the grid's y axis and the counts read from
    int32 arrays on the card.  Returns (B, Nq, k) d2 and idx; k above
    ``LARGE_K_MAX`` raises on the card."""
    _check_batched(query, ref, self_mode)
    if query.device.type == "cpu":
        return knn_select_torch_batched(query, ref, k, self_mode=self_mode,
                                        nr=nr, nq=nq)
    d2, idx, launched = _launch_batched(
        "knn_select_small_k", "knn_select_large_k", query, ref, k, self_mode,
        nr, nq, _padded_width(query.shape[2]))
    knn_select_batched.launches += launched
    return d2, idx


def knn_select_smalld(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                      self_mode: bool = False, nr: Counts = None,
                      nq: Counts = None
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
    up to ``LARGE_K_MAX``.  Exact, so it meets K8's and K9's <= 2^-12
    quantisation contract."""
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
                                            self_mode=self_mode, nr=nr, nq=nq)
        return knn_select_torch(query, ref, k, self_mode=self_mode, nr=nr)
    d = query.shape[-1]
    if not 1 <= d <= SMALLD_MAX:
        raise ValueError(f"knn_select_smalld takes 1 <= d <= {SMALLD_MAX}, "
                         f"got d={d}")
    if batched:
        d2, idx, launched = _launch_batched(
            "knn_select_smalld_small_k", "knn_select_smalld_large_k", query,
            ref, k, self_mode, nr, nq, d)
    else:
        if min(k, ref.shape[0]) > LARGE_K_MAX:
            raise ValueError(f"knn_select_smalld takes k <= {LARGE_K_MAX}, "
                             f"got k={k}")
        entry = ("knn_select_smalld_large_k" if k >= LARGE_K_FROM
                 else "knn_select_smalld_small_k")
        d2, idx, launched = _launch(entry, query, ref, k, self_mode, nr,
                                    dp=d)
    knn_select_smalld.launches += launched
    return d2, idx


KERNEL_WRAPPERS = (knn_select_small_k, knn_select_large_k, knn_select_batched,
                   knn_select_smalld)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0


def knn_select_cuda(query: torch.Tensor, ref: torch.Tensor, k: int, *,
                    self_mode: bool = False, nr: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact k-dependent dispatch: small-k kernel below
    ``LARGE_K_FROM`` candidates, large-k kernel from there.  The selection
    of the refine and device paths, and the counterpart of K4 where the
    ``fast`` precision uses the returned d2 directly."""
    sel = knn_select_large_k if k >= LARGE_K_FROM else knn_select_small_k
    return sel(query, ref, k, self_mode=self_mode, nr=nr)


def reset_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0
