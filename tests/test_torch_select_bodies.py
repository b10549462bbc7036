"""The selection bodies at their edges: the large-k body's warp-queue
boundaries and ties, the small-k body's rows per thread, tiles and screen.

On the CPU the plain version (``knn_select_torch``) is held to the JAX
package's exact selection, ``knn_select_xla``, at k = 33, 65 and 129 (one
key a lane past the warp queue's 32, 64 and 128) on a tied lattice and on
rows that are all one point.  JAX's ties may fall in another order, so the
comparison is ``assert_same_selection``'s: identical absent and self slots,
and the d2 at the returned indices within 2^-10.  The tests marked ``cuda``
hold the hand-written bodies (``csrc/knn_common.cuh``) to the plain version
on the card in the ``Padded``, ``Compact`` and batched forms; where every row
is one point they also require the exact tie order.  On the screen's
adversarial cases (``test_torch_select_screen.py``), grown past one step of
2 x 128 rows, the small-k body must return the float32 emulation's
selection bit for bit (ties by the smaller index) in every form: ``Padded``,
``Compact``, batched, ``TruncKey<11/12>`` and the prologue cut.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mcevidence_tpu.ops.knn import knn_select_xla
from mcevidence_tpu_torch.ops import knn_hopper as kh
from test_torch_knn import assert_same_selection
from test_torch_select_screen import CASES as SCREEN_CASES
from test_torch_select_screen import case_inputs, select_exact

WARP_QUEUE_KS = (31, 32, 33, 63, 64, 65, 128, 129, 255, 256)


def _grid(side, offset=0.0):
    return np.array(list(itertools.product(range(side), repeat=3)),
                    np.float32) + np.float32(offset)


def _inputs(case):
    """(query, ref, self_mode): a 6^3 lattice (every distance tied many
    times), with a half-step shifted 4^3 lattice as the cross queries; or
    300 rows of one point (every d2 = 0)."""
    if case.startswith("lattice"):
        ref = _grid(6)
        query = ref if case.endswith("self") else _grid(4, 0.5)
    else:
        ref = np.full((300, 5), 1.5, np.float32)
        query = ref if case.endswith("self") else ref[:40].copy()
    return query, ref, case.endswith("self")


CASES = [f"{data}_{mode}" for data in ("lattice", "one_point")
         for mode in ("self", "cross")]


@pytest.mark.parametrize("k", [33, 65, 129])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_exact_selection(case, k):
    query, ref, self_mode = _inputs(case)
    want = knn_select_xla(jnp.asarray(query), jnp.asarray(ref), k,
                          self_mode=self_mode)
    d2, idx = kh.knn_select_torch(torch.from_numpy(query),
                                  torch.from_numpy(ref), k,
                                  self_mode=self_mode)
    assert_same_selection(query, ref, d2.numpy(), idx.numpy(),
                          np.asarray(want[0]), np.asarray(want[1]),
                          self_mode=self_mode)


def tie_order(n_q, k, nr, self_mode):
    """The slots of a selection where every d2 is 0: in self mode the row
    itself, then 0, 1, ... without it; else 0, 1, ...; -1 past nr."""
    rank = np.arange(k)[None, :]
    rows = np.arange(n_q)[:, None]
    if self_mode:
        want = np.where(rank == 0, rows, rank - 1 + (rank - 1 >= rows))
    else:
        want = np.broadcast_to(rank, (n_q, k))
    return np.where(rank < min(nr, k), want, -1)


@pytest.mark.parametrize("self_mode", [True, False], ids=["self", "cross"])
def test_tie_order_of_one_point(self_mode):
    """Where every d2 is 0, the plain version's total order (d2 bits, then
    the index) written out: what the hand-written bodies must return index
    for index."""
    want = tie_order(6, 9, 300, self_mode)
    assert want.shape == (6, 9)
    if self_mode:
        assert (want[:, 0] == np.arange(6)).all()
        assert want[3, 1:5].tolist() == [0, 1, 2, 4]
        assert want[1, 1:4].tolist() == [0, 2, 3]
    else:
        assert (want == np.arange(9)).all()
    assert (tie_order(4, 9, 5, self_mode)[:, 5:] == -1).all()


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _card_inputs(rows, d, self_mode, one_point, device):
    rng = np.random.default_rng(rows + d)
    if one_point:
        ref = np.full((rows, d), 0.5, np.float32)
    else:
        ref = rng.normal(size=(rows, d)).astype(np.float32)
    query = ref if self_mode else rng.normal(size=(rows // 3, d)).astype(
        np.float32)
    if one_point and not self_mode:
        query = ref[: rows // 3].copy()
    r = torch.from_numpy(ref).to(device)
    q = r if self_mode else torch.from_numpy(query).to(device)
    return query, ref, q, r


def _check(query, ref, q, r, k, self_mode, nr, got, one_point):
    want = kh.knn_select_torch(q, r, k, self_mode=self_mode, nr=nr)
    torch.cuda.synchronize()
    got = [t.cpu().numpy() for t in got]
    assert_same_selection(query, ref, *[t.cpu().numpy() for t in want], *got,
                          self_mode=self_mode)
    if one_point:
        n_r = len(ref) if nr is None else nr
        np.testing.assert_array_equal(
            got[1], tie_order(len(query), got[1].shape[1], n_r, self_mode))


@pytest.mark.cuda
@pytest.mark.parametrize("self_mode", [True, False], ids=["self", "cross"])
@pytest.mark.parametrize("k", [1, 2, 5, 9, 13, 16] + list(WARP_QUEUE_KS))
@pytest.mark.parametrize("form", ["padded", "compact"])
def test_bodies_match_plain_on_card(form, k, self_mode, cuda_device):
    """5993 rows: no multiple of a tile or of a block's query rows."""
    d = 8 if form == "padded" else 5
    query, ref, q, r = _card_inputs(5993, d, self_mode, False, cuda_device)
    if form == "padded":
        fn = kh.knn_select_cuda
    else:
        fn = kh.knn_select_smalld
    got = fn(q, r, k, self_mode=self_mode)
    _check(query, ref, q, r, k, self_mode, None, got, False)


@pytest.mark.cuda
@pytest.mark.parametrize("self_mode", [True, False], ids=["self", "cross"])
@pytest.mark.parametrize("k", [9, 33, 129, 256])
@pytest.mark.parametrize("form", ["padded", "compact"])
@pytest.mark.parametrize("nr", [None, 100], ids=["all", "under_one_tile"])
def test_bodies_tie_order_of_one_point_on_card(nr, form, k, self_mode,
                                               cuda_device):
    d = 8 if form == "padded" else 5
    query, ref, q, r = _card_inputs(1000, d, self_mode, True, cuda_device)
    if nr is not None and self_mode:
        query, ref = query[:nr], ref[:nr]
        q = r = r[:nr]
    fn = kh.knn_select_cuda if form == "padded" else kh.knn_select_smalld
    got = fn(q, r, k, self_mode=self_mode, nr=nr)
    _check(query, ref, q, r, k, self_mode, nr, got, True)


@pytest.mark.cuda
@pytest.mark.parametrize("self_mode", [True, False], ids=["self", "cross"])
@pytest.mark.parametrize("k", [6, 13, 33, 65, 129, 256])
@pytest.mark.parametrize("one_point", [False, True], ids=["normal",
                                                          "one_point"])
def test_batched_bodies_match_plain_on_card(one_point, k, self_mode,
                                            cuda_device):
    """Members whose query counts cut a block (1001, 77, 3 rows) and one
    under one tile."""
    rng = np.random.default_rng(k)
    n = 2000
    if one_point:
        ref = np.full((3, n, 8), 0.5, np.float32)
    else:
        ref = rng.normal(size=(3, n, 8)).astype(np.float32)
    query = ref if self_mode else rng.normal(size=(3, 1001, 8)).astype(
        np.float32)
    if one_point and not self_mode:
        query = ref[:, :1001].copy()
    nq = [n, 77, 3] if self_mode else [1001, 77, 3]
    nr = nq if self_mode else [n, 1500, 100]
    r = torch.from_numpy(ref).to(cuda_device)
    q = r if self_mode else torch.from_numpy(query).to(cuda_device)
    for fn in (kh.knn_select_batched, kh.knn_select_smalld):
        got = fn(q, r, k, self_mode=self_mode, nr=nr, nq=nq)
        want = kh.knn_select_torch_batched(q, r, k, self_mode=self_mode,
                                           nr=nr, nq=nq)
        torch.cuda.synchronize()
        got = [t.cpu().numpy() for t in got]
        want = [t.cpu().numpy() for t in want]
        for b in range(3):
            assert (got[1][b, nq[b]:] == -1).all()
            assert np.isinf(got[0][b, nq[b]:]).all()
            assert_same_selection(query[b, :nq[b]], ref[b],
                                  want[0][b, :nq[b]], want[1][b, :nq[b]],
                                  got[0][b, :nq[b]], got[1][b, :nq[b]],
                                  self_mode=self_mode)
            if one_point:
                np.testing.assert_array_equal(
                    got[1][b, :nq[b]],
                    tie_order(nq[b], got[1].shape[2], nr[b], self_mode))


def _grown(case, width):
    """A screen case with its reference rows grown past one step of the
    small-k body (kSplit x kTile = 256 rows): reversed copies (more ties)
    and a half-scale copy."""
    q, r = case_inputs(case, width)
    r = np.concatenate([r, r[::-1], r * np.float32(0.5)])
    return q, np.ascontiguousarray(r)


def _same_bits(got, want):
    """(d2, idx) on the card against the emulation's: d2 bit for bit (any
    NaN against a NaN), idx exactly."""
    d2, idx = (t.cpu().numpy() for t in got)
    nan = np.isnan(want[0])
    np.testing.assert_array_equal(np.isnan(d2), nan)
    np.testing.assert_array_equal(d2.view(np.uint32)[~nan],
                                  want[0].view(np.uint32)[~nan])
    np.testing.assert_array_equal(idx, want[1])


SCREEN_FORMS = ("padded", "compact", "batched", "trunc11", "trunc12")


@pytest.mark.cuda
@pytest.mark.parametrize("form", SCREEN_FORMS)
@pytest.mark.parametrize("case", SCREEN_CASES)
def test_small_k_screen_keeps_the_bits_on_card(case, form, cuda_device):
    low_bits = int(form[5:]) if form.startswith("trunc") else 0
    for width, (self_mode, k) in itertools.product(
            (8, 16), ((True, 9), (False, 9), (False, 13), (True, 16))):
        q, r = _grown(case, width)
        if self_mode:
            q = r
        rt = torch.from_numpy(r).to(cuda_device)
        qt = rt if self_mode else torch.from_numpy(q).to(cuda_device)
        if form == "batched":
            nr = [len(r), len(r) - 37]
            nq = nr if self_mode else [len(q), len(q) - 5]
            qb = torch.stack([qt, qt.flip(0)])
            rb = qb if self_mode else torch.stack([rt, rt.flip(0)])
            got = kh.knn_select_batched(qb, rb, k, self_mode=self_mode,
                                        nr=nr, nq=nq, center=False)
            for b, (qm, rm) in enumerate(((q, r), (q[::-1], r[::-1]))):
                want = select_exact(np.ascontiguousarray(qm[:nq[b]]),
                                    np.ascontiguousarray(rm), k, self_mode,
                                    nr=nr[b], nan_bits=0x7FFFFFFF)
                _same_bits((got[0][b, :nq[b]], got[1][b, :nq[b]]), want)
                assert (got[1][b, nq[b]:] == -1).all()
            continue
        if form == "compact":
            got = kh.knn_select_smalld(qt, rt, k, self_mode=self_mode,
                                       center=False)
        elif low_bits:
            got = kh.knn_select_packed(qt, rt, k, self_mode=self_mode,
                                       low_bits=low_bits, center=False)
        else:      # k = 16 in self mode: 16 keys a row, one row a thread
            got = kh.knn_select_small_k(qt, rt, k, self_mode=self_mode,
                                        center=False)
        _same_bits(got, select_exact(q, r, k, self_mode, low_bits,
                                     nan_bits=0x7FFFFFFF))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["padded", "trunc11", "trunc12"])
@pytest.mark.parametrize("case", SCREEN_CASES)
def test_small_k_screen_keeps_the_bits_at_wide_layouts_on_card(
        case, form, cuda_device):
    """The small-k body on ``Padded<32>`` and ``<64>``, whose screen has the
    wider slack (W + 2) 2^-19, against the emulation bit for bit."""
    low_bits = int(form[5:]) if form.startswith("trunc") else 0
    for width, (self_mode, k) in itertools.product(
            (32, 64), ((True, 6), (False, 9), (True, 16))):
        q, r = _grown(case, width)
        if self_mode:
            q = r
        rt = torch.from_numpy(r).to(cuda_device)
        qt = rt if self_mode else torch.from_numpy(q).to(cuda_device)
        if low_bits:
            got = kh.knn_select_packed(qt, rt, k, self_mode=self_mode,
                                       low_bits=low_bits, center=False)
        else:
            got = kh.knn_select_small_k(qt, rt, k, self_mode=self_mode,
                                        center=False)
        _same_bits(got, select_exact(q, r, k, self_mode, low_bits,
                                     nan_bits=0x7FFFFFFF))


@pytest.mark.cuda
@pytest.mark.parametrize("self_mode", [True, False], ids=["self", "cross"])
@pytest.mark.parametrize("k", [2, 6, 9, 16, 26])
@pytest.mark.parametrize("d", [17, 26, 32, 33, 64])
def test_wide_padded_bodies_match_plain_on_card(d, k, self_mode,
                                                cuda_device):
    """The widths the device path now takes past 16 columns, padded to 32
    or 64: 5993 rows, both bodies (k = 26 takes the large-k one)."""
    query, ref, q, r = _card_inputs(5993, d, self_mode, False, cuda_device)
    got = kh.knn_select_cuda(q, r, k, self_mode=self_mode)
    _check(query, ref, q, r, k, self_mode, None, got, False)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["B", "BC"])
@pytest.mark.parametrize("width", [8, 16])
def test_small_k_screen_keeps_the_bits_under_the_prologue_cut(
        width, variant, cuda_device):
    """The prologue cut's sentinel rows (1e18) pad copies of the lattice
    case, whose masked mean the card computes exactly (small integers over
    a whole lattice), to a multiple of 128 rows."""
    _, lattice = case_inputs("lattice", width)
    inner = lattice[((lattice[:, :4] == 1) | (lattice[:, :4] == 2)).all(1)]
    r = np.concatenate([lattice, lattice, inner])
    n = len(r)
    mu = r.astype(np.float64).mean(0)
    assert np.array_equal(mu, mu.astype(np.float32)) and n % 128
    pad = -(-n // 128) * 128
    centred = np.concatenate([r - mu.astype(np.float32), np.full(
        (pad - n, width), 1e18, np.float32)]).astype(np.float32)
    rt = torch.from_numpy(r).to(cuda_device)
    for k in (5, 9, 14):
        got = kh.knn_select_prologue(rt, rt, k, variant=variant)
        _same_bits(got, select_exact(centred[:n], centred, k, True, 12,
                                     cut=True))
