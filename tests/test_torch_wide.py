"""The wide selection (``csrc/knn_wide.cu``, ``knn_select_wide``) and the
shapes it covers: k > 256 candidates and rows wider than 64 columns.

On the CPU the wrapper takes its plain version, held here to JAX's
``knn_select_xla`` at d = 65 and k = 257, and ``evidence_fn`` at such
shapes (refine at kmax = 60, whose guard reselects 4 (kmax + 4) + 8 = 264
candidates; a 65-parameter chain in refine, device and fast) is held to
JAX's.  The ``cuda``-marked cases hold the kernel to its plain version on
the card, bit for bit to the two bodies where both apply, and the card's
answers at d = 65 and k = 257 to JAX's.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mcevidence_tpu import evidence_fn as jax_evidence_fn
from mcevidence_tpu.ops.knn import exact_knn as jax_exact_knn
from mcevidence_tpu.ops.knn import knn_select_xla
from mcevidence_tpu_torch import evidence_fn
from mcevidence_tpu_torch.ops import knn_hopper as kh
from mcevidence_tpu_torch.ops.knn import exact_knn

from test_torch_knn import REL_TOL, assert_same_selection


def _gaussian_chain(rng, n, ndim, sigma=0.05):
    """tests/conftest.py's chain: drawn from its own Gaussian likelihood."""
    mean = np.arange(1.0, ndim + 1.0)
    sig = np.full(ndim, sigma)
    theta = rng.normal(mean, sig, size=(n, ndim))
    dm = (theta - mean) / sig
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 0.5 * ndim * np.log(2 * np.pi) - np.sum(np.log(sig)))
    return theta, lnl


def _jax_select(query, ref, k, self_mode):
    d2, idx = knn_select_xla(jnp.asarray(query), jnp.asarray(ref), k,
                             self_mode=self_mode)
    return np.asarray(d2), np.asarray(idx)


CASES = {
    "self_d65_k9": (65, 1500, None, 9),
    "cross_d100_k44": (100, 900, 1200, 44),
    "self_d8_k257": (8, 2000, None, 257),
    "cross_d8_k300": (8, 700, 1600, 300),
    "self_d65_k257": (65, 1200, None, 257),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_past_the_limits(case):
    d, nq, nr, k = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    query = rng.normal(size=(nq, d)).astype(np.float32)
    ref = query if nr is None else rng.normal(size=(nr, d)).astype(
        np.float32)
    self_mode = nr is None
    d2, idx = kh.knn_select_wide(torch.from_numpy(query),
                                 torch.from_numpy(ref), k,
                                 self_mode=self_mode)
    assert tuple(d2.shape) == (nq, k)
    jd2, jidx = _jax_select(query, ref, k, self_mode)
    assert_same_selection(query, ref, jd2, jidx, d2.numpy(), idx.numpy(),
                          self_mode)


def test_wide_on_cpu_is_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(300, 70))
                         .astype(np.float32))
    kh.reset_launch_counts()
    for low_bits in (0, 11, 12):
        got = kh.knn_select_wide(x, x, 260, self_mode=True,
                                 low_bits=low_bits)
        want = kh.knn_select_torch(x, x, 260, self_mode=True,
                                   low_bits=low_bits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = kh.knn_select_wide(x[None], x[None], 260, self_mode=True, nr=[200],
                             nq=[150])
    want = kh.knn_select_torch_batched(x[None], x[None], 260,
                                       self_mode=True, nr=[200], nq=[150])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kh.knn_select_wide.launches == 0
    with pytest.raises(ValueError, match="low_bits"):
        kh.knn_select_wide(x, x, 5, low_bits=7)


def test_wide_plan():
    """Route A (the warp-queue body) takes exact keys at d <= 64 and up to
    1024 kept keys, on the Padded width; route B (the list body) the rest:
    kp the kept keys rounded up to a power of two (at least 64), the most
    warps whose lists fit beside the tiles, a global workspace past 4096
    keys a row."""
    plan = kh.WidePlan
    assert kh.wide_plan(8, 263) == plan("A", 8, 512, 0, False)
    assert kh.wide_plan(3, 1024) == plan("A", 8, 1024, 0, False)
    assert kh.wide_plan(65, 8) == plan("B", 65, 64, 16, False)
    assert kh.wide_plan(8, 263, 11) == plan("B", 8, 512, 8, False)
    assert kh.wide_plan(8, 300, route="B") == plan("B", 8, 512, 8, False)
    assert kh.wide_plan(8, 2048) == plan("B", 8, 2048, 2, False)
    assert kh.wide_plan(8, 4096) == plan("B", 8, 4096, 1, False)
    assert kh.wide_plan(8, 8193) == plan("B", 8, 16384, 16, True)
    with pytest.raises(ValueError, match="too wide"):
        kh.wide_plan(100000, 9)


@pytest.mark.parametrize("low_bits", [0, 11])
@pytest.mark.parametrize("keep", [257, 512, 1024, 1025])
@pytest.mark.parametrize("d", [8, 64, 65])
def test_wide_route_rule(d, keep, low_bits):
    """A fixed rule on (d, keep, low_bits): exact keys, d <= 64 and
    keep <= 1024 take route A with 16 keys a lane up to 512 and 32 past
    it; everything else takes route B on rows of exactly d columns."""
    got = kh.wide_plan(d, keep, low_bits)
    if low_bits == 0 and d <= kh.D_MAX and keep <= kh.WARP_QUEUE_MAX:
        n = 16 if keep <= 512 else 32
        assert got == kh.WidePlan("A", kh._padded_width(d), 32 * n, 0,
                                  False)
        return
    assert got.route == "B" and got.width == d and not got.workspace
    assert got.kp == 1 << (keep - 1).bit_length() >= keep
    fits = [kh._list_shared_bytes(d, got.kp, w, False)
            <= kh._WIDE_SHARED_MAX for w in (got.warps, 2 * got.warps)]
    assert fits[0] and (got.warps == kh.LIST_MAX_WARPS or not fits[1])


@pytest.mark.parametrize("d,width", [(1, 8), (3, 8), (8, 8), (9, 16),
                                     (16, 16), (17, 32), (33, 64), (64, 64)])
def test_route_a_takes_the_padded_width(d, width):
    assert kh.wide_plan(d, 300).width == width == kh._padded_width(d)


def test_evidence_refine_kmax60_matches_jax():
    """kmax = 60: the first pass selects 64 candidates, the guard's retry
    264 (the wide kernel's shape on the card)."""
    theta, lnl = _gaussian_chain(np.random.default_rng(60), n=2500, ndim=4)
    got = evidence_fn(theta, lnl, kmax=60, device="cpu")
    want = jax_evidence_fn(theta, lnl, kmax=60, engine="xla")
    assert got.shape == (59,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def _wide_chain(n=1500, d=65, seed=5):
    rng = np.random.default_rng(seed)
    theta = rng.normal(1.0, 0.05, size=(n, d))
    lnl = -0.5 * np.sum(((theta - 1.0) / 0.05) ** 2, axis=1)
    return theta, lnl


@pytest.mark.parametrize("precision,atol", [("refine", 1e-9),
                                            ("device", 1e-9),
                                            ("fast", 3e-3)])
def test_evidence_d65_matches_jax(precision, atol):
    theta, lnl = _wide_chain()
    got = evidence_fn(theta, lnl, kmax=4, precision=precision, device="cpu")
    want = jax_evidence_fn(theta, lnl, kmax=4, precision=precision,
                           engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if precision != "fast":
        np.testing.assert_allclose(
            got, evidence_fn(theta, lnl, kmax=4, device="cpu"), rtol=0,
            atol=atol)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("low_bits", [0, 11, 12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_kernel_matches_plain_on_card(case, low_bits, cuda_device):
    d, nq, nr, k = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    query = torch.as_tensor(rng.normal(size=(nq, d)), dtype=torch.float32,
                            device=cuda_device)
    ref = query if nr is None else torch.as_tensor(
        rng.normal(size=(nr, d)), dtype=torch.float32, device=cuda_device)
    self_mode = nr is None
    before = kh.knn_select_wide.launches
    d2, idx = kh.knn_select_wide(query, ref, k, self_mode=self_mode,
                                 low_bits=low_bits)
    assert kh.knn_select_wide.launches == before + 1
    pd2, pidx = kh.knn_select_torch(query, ref, k, self_mode=self_mode,
                                    low_bits=low_bits)
    torch.cuda.synchronize()
    assert_same_selection(query.cpu().numpy(), ref.cpu().numpy(),
                          pd2.cpu().numpy(), pidx.cpu().numpy(),
                          d2.cpu().numpy(), idx.cpu().numpy(), self_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 44, 200, 256])
def test_wide_kernel_is_bit_identical_to_the_bodies(k, cuda_device):
    x = torch.as_tensor(np.random.default_rng(k).normal(size=(4096, 8)),
                        dtype=torch.float32, device=cuda_device)
    want = kh.knn_select_cuda(x, x, k, self_mode=True)
    got = kh.knn_select_wide(x, x, k, self_mode=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_card_answers_past_the_limits_like_jax(cuda_device):
    rng = np.random.default_rng(257)
    kh.reset_launch_counts()
    theta, lnl = _wide_chain()
    got = evidence_fn(theta, lnl, kmax=4, device="cuda")
    want = jax_evidence_fn(theta, lnl, kmax=4, engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    query = rng.normal(size=(3000, 8))
    got = exact_knn(query, None, 257, device="cuda")
    want = np.asarray(jax_exact_knn(query, None, 257, engine="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert kh.knn_select_wide.launches >= 2


def _assert_same_on_card(query, ref, pd2, pidx, d2, idx, self_mode):
    """``assert_same_selection`` with the f64 sums taken on the card."""
    assert d2.shape == pd2.shape
    assert torch.equal(idx < 0, pidx < 0)
    assert torch.equal(torch.isinf(d2), torch.isinf(pd2))
    if self_mode:
        rows = torch.arange(idx.shape[0], device=idx.device)
        assert torch.equal(idx[:, 0].long(), rows) and not d2[:, 0].any()
    want = torch.sort(pd2.double(), dim=1).values
    fin = torch.isfinite(want)
    q, r = query.double(), ref.double()
    for at in (idx, pidx):
        got = ((q[:, None, :] - r[at.clamp(min=0).long()]) ** 2).sum(-1)
        got = torch.sort(torch.where(at < 0, math.inf, got), dim=1).values
        err = (got[fin] - want[fin]).abs() / want[fin].clamp(min=1e-30)
        assert float(err.max()) <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("self_mode", [True, False])
@pytest.mark.parametrize("d", [3, 8, 32, 64])
@pytest.mark.parametrize("k", [257, 511, 512, 513, 1023, 1024, 1025])
def test_wide_queue_edges_match_plain_on_card(k, d, self_mode, cuda_device):
    """The warp queue's edges (512 and 1024 keys; route B past 1024 kept
    keys), batched with heterogeneous counts: member 1 cuts a block, member
    2 has fewer reference rows than k."""
    rng = np.random.default_rng(100 * k + d)
    n = 1200
    query = torch.as_tensor(rng.normal(size=(3, n, d)), dtype=torch.float32,
                            device=cuda_device)
    if self_mode:
        ref, nr = query, [n, 1037, 600]
        nq = nr
    else:
        ref = torch.as_tensor(rng.normal(size=(3, n + 100, d)),
                              dtype=torch.float32, device=cuda_device)
        nr, nq = [n + 100, 1037, 600], [n, 333, 17]
    before = kh.knn_select_wide.launches
    d2, idx = kh.knn_select_wide(query, ref, k, self_mode=self_mode, nr=nr,
                                 nq=nq)
    assert kh.knn_select_wide.launches == before + 1
    pd2, pidx = kh.knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr,
                                            nq=nq)
    torch.cuda.synchronize()
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        assert bool((idx[b, n_q:] == -1).all())
        assert int(idx[b].max()) < n_r
        _assert_same_on_card(query[b, :n_q], ref[b], pd2[b, :n_q],
                             pidx[b, :n_q], d2[b, :n_q], idx[b, :n_q],
                             self_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [300, 1024])
def test_wide_routes_return_the_same_bits(k, cuda_device):
    x = torch.as_tensor(np.random.default_rng(k).normal(size=(6000, 8)),
                        dtype=torch.float32, device=cuda_device)
    for self_mode in (True, False):
        assert kh.wide_plan(8, k - self_mode).route == "A"
        got = kh.knn_select_wide(x, x, k, self_mode=self_mode)
        route_b = kh._launch_wide(x, x, k, self_mode, None, None, 0, True,
                                  route="B")
        assert all(torch.equal(a, b) for a, b in zip(got, route_b))
