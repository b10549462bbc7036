"""The port's ring (``mcevidence_tpu_torch/parallel/ring.py``) against JAX.

Each case of tests/test_sharded.py runs here on a pool of 4 gloo ranks of
the CPU (rank processes with a file rendezvous; 2 x 2 for the dp x ring
grid cases), every rank calling the port's function with the same host
arrays, on ``device="cpu"`` (the kernels' plain versions).  The ranks must
agree with each other, and the answer is held, at that test's own
tolerance (2e-3 fast, 1e-9 refine, 1e-8 device), to JAX's sharded function
on the conftest's 8-device mesh (2 x 4 for the grid) and to the port's
one-device answer.  The rings of 1, 2 and 3 ranks (uneven shards) and of 4
must select the same candidates.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from mcevidence_tpu import evidence_fn as jax_evidence_fn
from mcevidence_tpu.parallel import ring as jax_ring
from mcevidence_tpu_torch import evidence_fn
from mcevidence_tpu_torch.ops.pipeline import device_refine_evidence
from mcevidence_tpu_torch.parallel import ring
from mcevidence_tpu_torch.parallel.launch import RankPool, check_backend
from tests.conftest import make_gaussian_chain

import test_torch_ring_ranks as ranks

FAST = 2e-3
REFINE = 1e-9
DEVICE = 1e-8


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("ring",))


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "ring"))


def on_ranks(pool, fn, *args, **kwargs):
    """``fn`` on every rank of the pool (device "cpu"); the ranks' answers
    must be equal; returns rank 0's."""
    got = pool.run(fn, *args, device="cpu", **kwargs)
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])
    return got[0]


def hold(got, jax_got, single, atol):
    np.testing.assert_allclose(got, jax_got, rtol=0, atol=atol,
                               equal_nan=True)
    np.testing.assert_allclose(got, single, rtol=0, atol=atol,
                               equal_nan=True)


def single(*args, **kwargs):
    return evidence_fn(*args, device="cpu", **kwargs)


# --- 1-D ring, fast precision ------------------------------------------------

def test_sharded_matches_single_device(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1024, ndim=4)
    got = on_ranks(pool, ring.sharded_auto_evidence, theta, lnl, kmax=4)
    hold(got, jax_ring.sharded_auto_evidence(theta, lnl, kmax=4, mesh=mesh8),
         single(theta, lnl, kmax=4, precision="fast"), FAST)


def test_sharded_uneven_padding(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1001, ndim=3)
    got = on_ranks(pool, ring.sharded_auto_evidence, theta, lnl, kmax=3)
    hold(got, jax_ring.sharded_auto_evidence(theta, lnl, kmax=3, mesh=mesh8),
         single(theta, lnl, kmax=3, precision="fast"), FAST)


def test_sharded_with_weights(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=512, ndim=3)
    w = rng.integers(1, 4, size=len(theta)).astype(float)
    got = on_ranks(pool, ring.sharded_auto_evidence, theta, lnl, weights=w,
                   kmax=2)
    hold(got, jax_ring.sharded_auto_evidence(theta, lnl, weights=w, kmax=2,
                                             mesh=mesh8),
         single(theta, lnl, weights=w, kmax=2, precision="fast"), FAST)


def test_sharded_cross_matches_single_device(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1600, ndim=3)
    s1, l1, s2 = theta[:900], lnl[:900], theta[900:]
    got = on_ranks(pool, ring.sharded_cross_evidence, s1, l1, s2, kmax=3)
    hold(got, jax_ring.sharded_cross_evidence(s1, l1, s2, kmax=3,
                                              mesh=mesh8),
         single(s1, l1, samples2=s2, kmax=3, precision="fast"), FAST)


def test_sharded_cross_uneven(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1501, ndim=3)
    s1, l1, s2 = theta[:737], lnl[:737], theta[737:]
    got = on_ranks(pool, ring.sharded_cross_evidence, s1, l1, s2, kmax=2)
    hold(got, jax_ring.sharded_cross_evidence(s1, l1, s2, kmax=2,
                                              mesh=mesh8),
         single(s1, l1, samples2=s2, kmax=2, precision="fast"), FAST)


# --- 1-D ring, refine precision ----------------------------------------------

def test_sharded_refine_matches_refine_oracle(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1003, ndim=4)
    got = on_ranks(pool, ring.sharded_auto_evidence, theta, lnl, kmax=4,
                   precision="refine")
    hold(got, jax_ring.sharded_auto_evidence(theta, lnl, kmax=4, mesh=mesh8,
                                             precision="refine"),
         single(theta, lnl, kmax=4), REFINE)


def test_sharded_refine_weighted(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=777, ndim=3)
    w = rng.integers(1, 5, size=len(theta)).astype(float)
    got = on_ranks(pool, ring.sharded_auto_evidence, theta, lnl, weights=w,
                   kmax=3, precision="refine")
    hold(got, jax_ring.sharded_auto_evidence(theta, lnl, weights=w, kmax=3,
                                             mesh=mesh8, precision="refine"),
         single(theta, lnl, weights=w, kmax=3), REFINE)


def test_sharded_cross_refine_matches_refine_oracle(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1600, ndim=3)
    s1, l1, s2 = theta[:901], lnl[:901], theta[901:]
    got = on_ranks(pool, ring.sharded_cross_evidence, s1, l1, s2, kmax=3,
                   precision="refine")
    hold(got, jax_ring.sharded_cross_evidence(s1, l1, s2, kmax=3, mesh=mesh8,
                                              precision="refine"),
         single(s1, l1, samples2=s2, kmax=3), REFINE)


# --- dp x ring grid ------------------------------------------------------------

def test_grid_refine_matches_refine_oracle(rng, pool, mesh2):
    chains = [make_gaussian_chain(rng, n=n, ndim=3) for n in (700, 903, 801)]
    pvs = [1.0, 2.0, 1.0]
    got = on_ranks(pool, ring.sharded_grid_evidence_refine, chains, kmax=3,
                   prior_volumes=pvs, dp=2)
    assert got.shape == (3, 2)
    want = jax_ring.sharded_grid_auto_evidence_refine(
        chains, kmax=3, mesh=mesh2, prior_volumes=pvs)
    hold(got, want, [single(t, ll, kmax=3, prior_volume=pv)
                     for (t, ll), pv in zip(chains, pvs)], REFINE)


def test_grid_evidence_2d_mesh(rng, pool, mesh2):
    chains = [make_gaussian_chain(rng, n=n, ndim=3) for n in (700, 900, 801)]
    pvs = [1.0, 2.0, 1.0]
    got = on_ranks(pool, ring.sharded_grid_auto_evidence, chains, kmax=3,
                   prior_volumes=pvs, dp=2)
    assert got.shape == (3, 2)
    want = jax_ring.sharded_grid_auto_evidence(chains, kmax=3, mesh=mesh2,
                                               prior_volumes=pvs)
    # JAX's grid program takes uncentred f32 moments (ROADMAP Queue 3): the
    # test_sharded.py tolerance of this case, 3e-3
    hold(got, want, [single(t, ll, kmax=3, precision="fast", prior_volume=pv)
                     for (t, ll), pv in zip(chains, pvs)], 3e-3)


# --- device precision ----------------------------------------------------------

def test_sharded_device_refine(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1003, ndim=4)
    w = rng.integers(1, 4, size=len(theta)).astype(float)
    got = on_ranks(pool, ring.sharded_device_refine_evidence, theta, lnl, w,
                   kmax=4)
    hold(got, jax_ring.sharded_device_refine_evidence(
        theta, lnl, w, kmax=4, mesh=mesh8, engine="xla"),
        single(theta, lnl, weights=w, kmax=4), DEVICE)


def test_sharded_device_refine_cross(rng, pool, mesh8):
    theta, lnl = make_gaussian_chain(rng, n=1600, ndim=3)
    s1, l1, s2 = theta[:901], lnl[:901], theta[901:]
    got = on_ranks(pool, ring.sharded_device_refine_evidence, s1, l1,
                   samples2=s2, kmax=3)
    hold(got, jax_ring.sharded_device_refine_evidence(
        s1, l1, samples2=s2, kmax=3, mesh=mesh8, engine="xla"),
        single(s1, l1, samples2=s2, kmax=3), DEVICE)


def _grid_chains():
    chains = []
    for i, (n, d) in enumerate([(1100, 3), (700, 4), (1500, 3)]):
        th, lnl = make_gaussian_chain(np.random.default_rng(50 + i), n=n,
                                      ndim=d)
        w = np.random.default_rng(60 + i).integers(1, 4, size=n)
        chains.append((th, lnl, w.astype(float)))
    return chains


def test_grid_device_refine_matches_oracle(pool, mesh2):
    pvs = [1.0, 2.0, 0.5]
    chains = _grid_chains()
    got = on_ranks(pool, ring.sharded_grid_device_refine_evidence, chains,
                   kmax=3, prior_volumes=pvs, dp=2)
    assert got.shape == (3, 2)
    want = jax_ring.sharded_grid_device_refine_evidence(
        chains, kmax=3, prior_volumes=pvs, mesh=mesh2, engine="xla")
    hold(got, want, [single(th, lnl, weights=w, kmax=3, prior_volume=pv)
                     for (th, lnl, w), pv in zip(chains, pvs)], DEVICE)


def test_grid_device_refine_importance_sumw(rng, pool, mesh2):
    th, lnl = make_gaussian_chain(rng, n=900, ndim=3)
    w = np.ones(900)
    got = on_ranks(pool, ring.sharded_grid_device_refine_evidence,
                   [(th, lnl, w)], kmax=2, dp=2,
                   sum_adjusted_weights=[2.0 * w.sum()])
    want = jax_ring.sharded_grid_device_refine_evidence(
        [(th, lnl, w)], kmax=2, mesh=mesh2, engine="xla",
        sum_adjusted_weights=[2.0 * w.sum()])
    hold(got[0], want[0], single(th, lnl, weights=w, kmax=2,
                                 sum_adjusted_weights=2.0 * w.sum()),
         DEVICE)


def test_grid_device_refine_cross(pool, mesh2):
    chains, refs = [], []
    for i, (n, m, d) in enumerate([(800, 600, 3), (500, 900, 4)]):
        th, lnl = make_gaussian_chain(np.random.default_rng(70 + i),
                                      n=n + m, ndim=d)
        chains.append((th[:n], lnl[:n]))
        refs.append(th[n:])
    got = on_ranks(pool, ring.sharded_grid_device_refine_evidence, chains,
                   chains2=refs, kmax=3, dp=2)
    want = jax_ring.sharded_grid_device_refine_evidence(
        chains, chains2=refs, kmax=3, mesh=mesh2, engine="xla")
    hold(got, want, [single(th, lnl, samples2=r, kmax=3)
                     for (th, lnl), r in zip(chains, refs)], DEVICE)


def test_grid_device_refine_defer(pool, mesh2):
    """defer=True returns a finalize callable whose result equals the
    eager call's, on every rank."""
    chains = []
    for i, (n, d) in enumerate([(900, 3), (650, 4)]):
        chains.append(make_gaussian_chain(np.random.default_rng(70 + i), n=n,
                                          ndim=d))
    got = pool.run(ranks.grid_device_refine_defer, chains, kmax=3, dp=2,
                   device="cpu")
    for eager, is_callable, deferred in got:
        assert is_callable
        np.testing.assert_array_equal(deferred, eager)
        np.testing.assert_array_equal(eager, got[0][0])
    want = jax_ring.sharded_grid_device_refine_evidence(chains, kmax=3,
                                                        mesh=mesh2,
                                                        engine="xla")
    hold(got[0][0], want, [single(th, lnl, kmax=3) for th, lnl in chains],
         DEVICE)


# --- tiny references, short chains, fallbacks ---------------------------------

def test_sharded_device_refine_tiny_reference(rng, pool):
    """kmax > n_ref: undefined columns come back NaN, defined ones match
    the one-device device path (and JAX's sharded one)."""
    th, lnl = make_gaussian_chain(rng, n=520, ndim=3)
    ref = th[:3]
    got = on_ranks(pool, ring.sharded_device_refine_evidence, th, lnl,
                   samples2=ref, kmax=4)
    assert got.shape == (3,)
    assert np.isfinite(got[:2]).all() and np.isnan(got[2])
    # test_sharded.py holds JAX's two device paths at 1e-9; JAX's
    # double-float one and the port's native f64 one sit 2.3e-9 apart here,
    # inside the device gate
    hold(got, jax_ring.sharded_device_refine_evidence(
        th, lnl, samples2=ref, kmax=4, engine="xla"),
        device_refine_evidence(th, lnl, samples2=ref, kmax=4, device="cpu"),
        DEVICE)


def test_sharded_device_refine_overflow_falls_back(rng, pool):
    """Non-finite partials take the ring's refine path on every rank."""
    th, lnl = make_gaussian_chain(rng, n=640, ndim=3)
    got = pool.run(ranks.device_refine_with_overflow, th, lnl, kmax=3,
                   device="cpu")
    for lnz, messages in got:
        np.testing.assert_array_equal(lnz, got[0][0])
        assert any("non-finite sum" in m for m in messages)
    hold(got[0][0], jax_evidence_fn(th, lnl, kmax=3, engine="xla"),
         single(th, lnl, kmax=3), REFINE)


def test_grid_refine_short_chain_nan_row(rng, pool):
    """A short chain (n_ref < kmax) fills only its defined columns."""
    th1, lnl1 = make_gaussian_chain(rng, n=700, ndim=3)
    th2, lnl2 = make_gaussian_chain(rng, n=3, ndim=3)
    chains = [(th1, lnl1), (th2, lnl2)]
    got = on_ranks(pool, ring.sharded_grid_evidence_refine, chains, kmax=4)
    assert got.shape == (2, 3)
    assert np.isfinite(got[0]).all()
    assert np.isfinite(got[1, :1]).all() and np.isnan(got[1, 2])
    want = jax_ring.sharded_grid_evidence_refine(chains, kmax=4)
    hold(got, want, ring.sharded_grid_evidence_refine(chains, kmax=4,
                                                      device="cpu"), REFINE)
    np.testing.assert_allclose(got[0], single(th1, lnl1, kmax=4), rtol=0,
                               atol=REFINE)


def test_sharded_fast_small_n_returns_nan_not_inf(rng, pool):
    """n (or n_ref) < kmax: columns past the last real neighbour are NaN,
    never +inf."""
    th, lnl = make_gaussian_chain(rng, n=3, ndim=2)
    out = on_ranks(pool, ring.sharded_auto_evidence, th, lnl, kmax=5)
    assert out.shape == (4,)
    assert not np.isinf(out).any() and np.isnan(out[2:]).all()
    np.testing.assert_allclose(out, jax_ring.sharded_auto_evidence(
        th, lnl, kmax=5, precision="fast"), rtol=0, atol=FAST,
        equal_nan=True)
    big, lnlb = make_gaussian_chain(rng, n=500, ndim=2)
    outx = on_ranks(pool, ring.sharded_cross_evidence, big, lnlb, th[:2],
                    kmax=5)
    assert not np.isinf(outx).any() and np.isnan(outx[2:]).all()
    np.testing.assert_allclose(outx, jax_ring.sharded_cross_evidence(
        big, lnlb, th[:2], kmax=5, precision="fast"), rtol=0, atol=FAST,
        equal_nan=True)


def test_sharded_device_refine_wide_ndim_falls_back(rng, pool):
    """ndim > D_MAX (65 columns, one past the kernels' widest layout)
    takes the ring's refine path."""
    th = rng.normal(size=(400, 65))
    lnl = -0.5 * np.sum(th * th, axis=1)
    got = pool.run(ranks.call_logging, ring.sharded_device_refine_evidence,
                   th, lnl, kmax=2, device="cpu")
    for lnz, messages in got:
        np.testing.assert_array_equal(lnz, got[0][0])
        assert any("falling back to the sharded refine path" in m
                   for m in messages)
    want = on_ranks(pool, ring.sharded_auto_evidence, th, lnl, kmax=2,
                    precision="refine")
    np.testing.assert_allclose(got[0][0], want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0][0], jax_ring.sharded_auto_evidence(
        th, lnl, kmax=2, precision="refine"), rtol=0, atol=REFINE)


# --- the ring itself -------------------------------------------------------------

@pytest.mark.parametrize("case", ["self", "cross"])
def test_world_sizes_select_the_same_candidates(case, pool):
    """Rings of 1, 2, 3 (uneven shards) and 4 ranks select the same
    candidate indices as one selection over the whole chain."""
    rng = np.random.default_rng(11)
    query = rng.normal(size=(1001, 5))
    ref = None if case == "self" else rng.normal(size=(777, 5))
    got = pool.run(ranks.selections_by_world_size, query, ref, 13,
                   (1, 2, 3, 4), device="cpu")
    want = got[0][1]
    for rank, by_size in enumerate(got):
        assert sorted(by_size) == [n for n in (1, 2, 3, 4) if rank < n]
        for n, idx in by_size.items():
            np.testing.assert_array_equal(idx, want, err_msg=f"ring of {n}")
    assert want.shape == (1001, 13) and (want >= 0).all()
    if case == "self":
        np.testing.assert_array_equal(want[:, 0], np.arange(1001))


def test_nccl_with_shared_cards_raises_naming_gloo():
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", ["cpu"])
    check_backend("nccl", ["cuda:0", "cuda:1"])
    check_backend("gloo", ["cuda:0", "cuda:0"])


def test_grid_layout_rings(pool):
    """dp=2 over 4 ranks: rings {0, 1} and {2, 3}."""
    got = pool.run(ranks.layout_of, 2)
    assert got == [(0, (0, 1), 0), (0, (0, 1), 1), (1, (2, 3), 0),
                   (1, (2, 3), 1)]


def test_ring_and_entry_modules_load_no_jax():
    code = ("import sys\n"
            "import mcevidence_tpu_torch.parallel.ring\n"
            "import mcevidence_tpu_torch.parallel.launch\n"
            "import mcevidence_tpu_torch.graft_entry\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mcevidence_tpu.'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
