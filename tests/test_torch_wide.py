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

from test_torch_knn import assert_same_selection


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
    """kp: the kept keys rounded up to a power of two (at least 64); eight
    warps while their lists fit beside the tile, fewer past 1024 keys, a
    global workspace past 8192."""
    assert kh.wide_plan(8) == (64, 8, False)
    assert kh.wide_plan(263) == (512, 8, False)
    assert kh.wide_plan(1024) == (1024, 8, False)
    assert kh.wide_plan(2048) == (2048, 4, False)
    assert kh.wide_plan(8192) == (8192, 1, False)
    assert kh.wide_plan(8193) == (16384, 8, True)


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
