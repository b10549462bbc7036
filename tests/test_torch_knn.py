"""The port's kNN selection and refine path against the JAX package.

On the CPU the kernel wrappers run their plain version, ``knn_select_torch``;
it is held to the Pallas kernels K1 (``knn_select_pallas_packed2``) and K2
(``knn_select_pallas_binned(packed=True)``) run in interpret mode, as the
JAX package's own tests run them.  Criterion (scripts/tpu_kernel_cert.py):
the d2 recomputed in f64 at the returned indices within 2^-10 relative, and
identical self and absent slots.  The batched plain version is held to K5
(``knn_select_pallas_packed2_batched``) the same way, member by member, and
the small-d wrapper (the plain version on the CPU) to K8 and K9
(``knn_select_pallas_smalld[_batched]``).  The exact dispatch is held to K4
(``knn_select_pallas``), whose returned d2 the ``fast`` precision consumes.
The tests marked ``cuda`` hold the hand-written kernels to the plain version
on the card and skip elsewhere.
"""

import itertools
import logging
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mcevidence_tpu.ops.knn import exact_knn as jax_exact_knn
from mcevidence_tpu.ops.knn_pallas import (knn_select_pallas,
                                           knn_select_pallas_binned,
                                           knn_select_pallas_packed2,
                                           knn_select_pallas_packed2_batched,
                                           knn_select_pallas_smalld,
                                           knn_select_pallas_smalld_batched)
from mcevidence_tpu_torch.ops import _build, pipeline
from mcevidence_tpu_torch.ops import knn as knn_mod
from mcevidence_tpu_torch.ops import knn_hopper as kh
from mcevidence_tpu_torch.bench import synthetic_chain
from mcevidence_tpu_torch.ops.knn import exact_knn, resolve_engine, selector

REL_TOL = 2.0 ** -10


def f64_d2_at(query, ref, idx):
    """f64 squared distances at the returned indices (-1 -> +inf), sorted."""
    q = np.asarray(query, np.float64)
    r = np.asarray(ref, np.float64)
    d2 = np.sum((q[:, None, :] - r[np.maximum(idx, 0)]) ** 2, axis=-1)
    return np.sort(np.where(idx < 0, np.inf, d2), axis=1)


def assert_same_selection(query, ref, plain_d2, plain_idx, d2, idx,
                          self_mode):
    """A selection agrees with the plain version's: absent and self slots
    exactly; the f64 d2 at its indices within REL_TOL of the plain d2."""
    plain_d2, plain_idx = np.asarray(plain_d2), np.asarray(plain_idx)
    d2, idx = np.asarray(d2), np.asarray(idx)
    assert d2.shape == plain_d2.shape
    np.testing.assert_array_equal(idx < 0, plain_idx < 0)
    np.testing.assert_array_equal(np.isinf(d2), np.isinf(plain_d2))
    if self_mode:
        rows = np.arange(len(idx))
        np.testing.assert_array_equal(idx[:, 0], rows)
        np.testing.assert_array_equal(plain_idx[:, 0], rows)
        assert not d2[:, 0].any() and not plain_d2[:, 0].any()
    want = np.sort(plain_d2.astype(np.float64), axis=1)
    fin = np.isfinite(want)
    for at in (idx, plain_idx):
        got = f64_d2_at(query, ref, at)
        err = np.abs(got[fin] - want[fin]) / np.maximum(want[fin], 1e-30)
        assert err.max(initial=0.0) <= REL_TOL


def _plain(query, ref, k, self_mode, nr=None):
    d2, idx = kh.knn_select_torch(torch.from_numpy(query),
                                  torch.from_numpy(ref), k,
                                  self_mode=self_mode, nr=nr)
    return d2.numpy(), idx.numpy()


def _lattice(side=8):
    return np.array(list(itertools.product(range(side), repeat=3)),
                    np.float32)


def _k1_cases():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    q = rng.normal(size=(130, 4)).astype(np.float32)
    r = rng.normal(size=(1030, 4)).astype(np.float32)
    garbage = np.concatenate([r[:300], np.full((100, 4), 1e8, np.float32)])
    dup = x.copy()
    dup[1::7] = dup[0::7][: len(dup[1::7])]
    tiny = np.zeros((64, 4), np.float32)
    tiny[:3] = rng.normal(size=(3, 4))
    return {
        "self": (x, x, 6, True, None),
        "cross": (q, r, 5, False, None),
        "self_nr_garbage": (garbage[:300], garbage, 5, True, 300),
        "cross_nr_garbage": (q, garbage, 5, False, 300),
        "cross_k_gt_nr": (q[:8], tiny, 5, False, 3),
        "self_duplicates": (dup, dup, 6, True, None),
    }


K1_CASES = _k1_cases()


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_plain_matches_pallas_k1(case):
    query, ref, k, self_mode, nr = K1_CASES[case]
    want = knn_select_pallas_packed2(jnp.asarray(query), jnp.asarray(ref), k,
                                     self_mode=self_mode, interpret=True,
                                     nr=nr)
    plain = _plain(query, ref, k, self_mode, nr)
    assert_same_selection(query, ref, *plain, *want, self_mode=self_mode)
    if nr is not None:
        assert plain[1].max() < nr


@pytest.mark.parametrize("k", [14, 26, 32])
def test_plain_matches_pallas_k2_on_lattice(k):
    x = _lattice()
    want = knn_select_pallas_binned(jnp.asarray(x), jnp.asarray(x), k,
                                    self_mode=True, interpret=True,
                                    packed=True)
    assert_same_selection(x, x, *_plain(x, x, k, True), *want,
                          self_mode=True)


K5_TOL = 2.0 ** -11          # K5's packed quantisation bound


def _batch(rng, ns, rows, d, garbage=1e8):
    """(B, rows, d) f32 members whose rows at or past ns[b] hold garbage."""
    x = rng.normal(size=(len(ns), rows, d)).astype(np.float32)
    for b, n in enumerate(ns):
        x[b, n:] = garbage
    return x


def _k5_cases():
    rng = np.random.default_rng(29)
    q = _batch(rng, [260, 211, 97], 260, 5)
    r = _batch(rng, [380, 333, 20], 380, 5)
    dup = _batch(rng, [150, 120], 150, 3)
    dup[:, 1::5] = dup[:, 0::5][:, : dup[:, 1::5].shape[1]]
    return {
        "self": (q, q, True, [260, 211, 97], [260, 211, 97]),
        "cross": (q, r, False, [380, 333, 20], [260, 211, 97]),
        "self_duplicates_d3": (dup, dup, True, [150, 120], [150, 120]),
    }


K5_CASES = _k5_cases()


def _unambiguous_rows(d2_next):
    """Rows whose first k+1 plain d2 are strictly separated by more than
    the quantisation: any exact or quantised selection must return the
    same indices in the same order there."""
    d2 = np.asarray(d2_next, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = d2[:, 1:] / d2[:, :-1]
    sep = (ratio > 1 + 2 * K5_TOL) | np.isinf(d2[:, 1:])
    return sep.all(axis=1)


@pytest.mark.parametrize("k", [6, 9, 26])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_plain_batched_matches_pallas_k5(case, k):
    query, ref, self_mode, nr, nq = K5_CASES[case]
    want_d2, want_idx = (np.asarray(a) for a in
                         knn_select_pallas_packed2_batched(
                             jnp.asarray(query), jnp.asarray(ref), k,
                             self_mode=self_mode, interpret=True,
                             nr=np.asarray(nr, np.int32)))
    got_d2, got_idx = (a.numpy() for a in kh.knn_select_torch_batched(
        torch.from_numpy(query), torch.from_numpy(ref), k,
        self_mode=self_mode, nr=nr, nq=nq))
    assert got_d2.shape == (len(nr), query.shape[1], min(k, ref.shape[1]))
    checked = 0
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        gi, wi = got_idx[b, :n_q], want_idx[b, :n_q]
        np.testing.assert_array_equal(gi < 0, wi < 0)
        assert gi.max() < n_r and (got_idx[b, n_q:] == -1).all()
        assert np.isinf(got_d2[b, n_q:]).all()
        if self_mode:
            np.testing.assert_array_equal(gi[:, 0], np.arange(n_q))
        # indices: equal wherever the k+1 nearest are not near-tied
        nxt = kh.knn_select_torch(torch.from_numpy(query[b, :n_q]),
                                  torch.from_numpy(ref[b]), k + 1,
                                  self_mode=self_mode, nr=n_r)[0].numpy()
        clear = _unambiguous_rows(nxt)
        np.testing.assert_array_equal(gi[clear], wi[clear])
        checked += int(clear.sum())
        # d2: K5 quantises down by <= 2^-11, and its matrix-product
        # identity leaves an exact duplicate the f32 rounding of |q|^2
        # (~1e-7 here) instead of 0; at near-ties its indices may differ,
        # but the f64 d2 at them must not
        fin = np.isfinite(got_d2[b, :n_q])
        plain = got_d2[b, :n_q][fin]
        err = np.abs(np.sort(want_d2[b, :n_q], 1)[fin] - plain)
        assert (err <= K5_TOL * plain + 1e-6).all()
        for at in (gi, wi):
            rel = (np.abs(f64_d2_at(query[b, :n_q], ref[b], at)[fin]
                          - got_d2[b, :n_q][fin])
                   / np.maximum(got_d2[b, :n_q][fin], 1e-30))
            assert rel.max(initial=0.0) <= K5_TOL
    if "duplicates" not in case:
        # the index comparison is not vacuous (near-ties grow with k; with
        # duplicates every neighbourhood holds exact ties)
        assert checked > 0.25 * sum(nq)


def test_batched_wrapper_on_cpu_is_the_plain_loop():
    query, ref, self_mode, nr, nq = K5_CASES["cross"]
    q, r = torch.from_numpy(query), torch.from_numpy(ref)
    kh.reset_launch_counts()
    d2, idx = kh.knn_select_batched(q, r, 9, self_mode=False, nr=nr, nq=nq)
    for b in range(len(nr)):
        want = kh.knn_select_torch(q[b, :nq[b]], r[b], 9, nr=nr[b])
        assert torch.equal(d2[b, :nq[b]], want[0])
        assert torch.equal(idx[b, :nq[b]], want[1])
    assert kh.knn_select_batched.launches == 0
    with pytest.raises(ValueError, match="nr=400"):
        kh.knn_select_batched(q, r, 9, nr=[400, 1, 1])
    with pytest.raises(ValueError, match="entries"):
        kh.knn_select_batched(q, r, 9, nr=[1, 1])
    with pytest.raises(ValueError, match=r"\(B, Nq, d\)"):
        kh.knn_select_batched(q[0], r[0], 9)


def _knn_inputs(rng, case):
    if case == "self":
        return rng.normal(size=(400, 5)), None, 4
    if case == "cross":
        return rng.normal(size=(250, 4)), rng.normal(size=(380, 4)), 5
    if case == "offset":
        shift = np.array([1e4, -2e4, 3e4, 0.5, -1e3, 7e3])
        return rng.normal(size=(300, 6)) + shift, None, 3
    # a 3-D lattice: equidistant neighbours make the guard re-select
    return _lattice().astype(np.float64), None, 2


@pytest.mark.parametrize("engine", ["auto", "cuda", "torch"])
@pytest.mark.parametrize("case", ["self", "cross", "offset", "lattice"])
def test_exact_knn_matches_reference(case, engine, caplog):
    query, ref, k = _knn_inputs(np.random.default_rng(5), case)
    want = jax_exact_knn(query, ref, k, engine="xla")
    with caplog.at_level(logging.INFO,
                         logger="mcevidence_tpu_torch.ops.knn"):
        got = exact_knn(query, ref, k, engine=engine, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    retried = [r for r in caplog.records
               if r.name == "mcevidence_tpu_torch.ops.knn"
               and "re-selecting with 32 candidates" in r.message]
    assert len(retried) == (1 if case == "lattice" else 0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(200, 6)).astype(np.float32))
    kh.reset_launch_counts()
    for wrapper, k in ((kh.knn_select_small_k, 7),
                       (kh.knn_select_large_k, 20)):
        for self_mode, nr in ((True, None), (False, 150)):
            got = wrapper(x, x, k, self_mode=self_mode, nr=nr)
            want = kh.knn_select_torch(x, x, k, self_mode=self_mode, nr=nr)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    exact_knn(x.double().numpy(), None, 3, engine="cuda", device="cpu")
    assert kh.knn_select_small_k.launches == 0
    assert kh.knn_select_large_k.launches == 0


def test_engine_aliases_and_unknown_names():
    assert [resolve_engine(e) for e in ("auto", "cuda", "pallas",
                                        "pallas_exact")] == ["cuda"] * 4
    assert resolve_engine("pallas_smalld") == "smalld"
    assert [resolve_engine(e) for e in ("pallas_packed", "pallas_packed2",
                                        "pallas_binned")] == [
        "packed", "packed2", "binned"]
    assert [resolve_engine(e) for e in ("torch", "xla")] == ["torch"] * 2
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine("tpu")


def test_smalld_dispatch_follows_the_reference():
    """knn.py:335-345: the small-d kernel for refine consumers at d <= 16;
    wider inputs and directly-used distances take the exact dispatch."""
    assert selector("pallas_smalld", "refine",
                    width=16) is kh.knn_select_smalld
    assert selector("pallas_smalld", "batched",
                    width=3) is kh.knn_select_smalld
    assert selector("pallas_smalld", "refine",
                    width=17) is kh.knn_select_cuda
    assert selector("pallas_smalld", "batched",
                    width=17) is kh.knn_select_batched
    assert selector("pallas_smalld", "fast",
                    width=3) is kh.knn_select_cuda
    assert selector("pallas_exact", "refine", width=3) is kh.knn_select_cuda
    assert selector("xla", "fast", width=3) is kh.knn_select_torch


# K4 (knn_select_pallas) takes its d2 by the matrix-product identity in f32,
# the port by differences: they differ by the identity's rounding, a few
# ulps of |q|^2 + |r|^2 (bounded here by 2^-18 of it), and near-tied rows
# may swap indices, so d2 are compared sorted and indices where unambiguous
K4_ULPS = 2.0 ** -18


@pytest.mark.parametrize("case,k", [("self", 6), ("cross", 5),
                                    ("self_nr_garbage", 5),
                                    ("cross_k_gt_nr", 5),
                                    ("self_duplicates", 6), ("self", 20),
                                    ("cross", 30)])
def test_exact_dispatch_matches_pallas_k4(case, k):
    query, ref, _, self_mode, nr = K1_CASES[case]
    want_d2, want_idx = (np.asarray(a) for a in knn_select_pallas(
        jnp.asarray(query), jnp.asarray(ref), k, self_mode=self_mode,
        interpret=True, nr=nr))
    got_d2, got_idx = _plain(query, ref, k, self_mode, nr)
    assert_same_selection(query, ref, got_d2, got_idx, want_d2, want_idx,
                          self_mode=self_mode)
    # the returned d2 themselves, which fast mode consumes
    n_ref = ref.shape[0] if nr is None else nr
    mu = ref[:n_ref].astype(np.float64).mean(axis=0)
    scale = (np.sum((query - mu) ** 2, axis=1, keepdims=True)
             + np.max(np.sum((ref[:n_ref] - mu) ** 2, axis=1)))
    fin = np.isfinite(got_d2)
    err = np.abs(np.sort(want_d2, 1)[fin] - got_d2[fin])
    assert (err <= K4_ULPS * np.broadcast_to(scale, fin.shape)[fin]).all()
    clear = _unambiguous_rows(_plain(query, ref, k + 1, self_mode, nr)[0])
    if "duplicates" not in case:
        np.testing.assert_array_equal(got_idx[clear], want_idx[clear])


@pytest.mark.parametrize("case", ["self", "cross", "offset"])
def test_exact_knn_unrefined_matches_reference(case):
    """exact_knn(refine=False): sqrt of the selection's f32 d2, against the
    JAX package's on its plain XLA selection (matrix identity in f32)."""
    query, ref, k = _knn_inputs(np.random.default_rng(5), case)
    want = jax_exact_knn(query, ref, k, refine=False, engine="xla")
    got = exact_knn(query, ref, k, refine=False, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(got[:, 0] == 0, want[:, 0] == 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    refined = exact_knn(query, ref, k, device="cpu")
    np.testing.assert_allclose(got, refined, rtol=1e-6, atol=1e-7)


def _host_composition(query, ref, k, pad=4):
    """``exact_knn(refine=True)`` as it was composed before the refine moved
    to the selection's device: the f32 cast on the host, the plain
    selection, and the numpy refine and guard on the host indices."""
    self_mode = ref is None
    q_np, r_np = knn_mod.center_f64(query, ref)
    q32 = torch.as_tensor(q_np, dtype=torch.float32)
    r32 = q32 if self_mode else torch.as_tensor(r_np, dtype=torch.float32)
    nr = r_np.shape[0]
    k = min(k, nr)
    k_sel = min(nr, k + pad)

    def select(ks):
        return kh.knn_select_torch(q32, r32, ks,
                                   self_mode=self_mode)[1].numpy()
    if k_sel == nr:
        return knn_mod.refine_knn_f64(q_np, r_np, select(k_sel), k,
                                      self_mode)
    return knn_mod.guarded_refine_knn_f64(q_np, r_np, select(k_sel), k,
                                          self_mode=self_mode,
                                          reselect=select)


# the device refine sums over d in another order than numpy's einsum: a few
# ulps of each distance
REFINE_RTOL = 2e-15


@pytest.mark.parametrize("case", ["self", "cross", "offset", "lattice",
                                  "k_sel_is_nr"])
def test_exact_knn_matches_the_host_composition(case):
    if case == "k_sel_is_nr":
        rng = np.random.default_rng(6)
        query, ref, k = rng.normal(size=(50, 3)), rng.normal(size=(7, 3)), 5
    else:
        query, ref, k = _knn_inputs(np.random.default_rng(5), case)
    np.testing.assert_allclose(exact_knn(query, ref, k, device="cpu"),
                               _host_composition(query, ref, k),
                               rtol=REFINE_RTOL, atol=0)


@pytest.mark.parametrize("chunk_bytes", [None, 6000])
@pytest.mark.parametrize("self_mode", [True, False])
def test_device_refine_matches_host_refine(self_mode, chunk_bytes,
                                           monkeypatch):
    """``refine_knn_on_device`` on CPU tensors against the numpy refine on
    the same indices: absent (-1) slots, own rows, chunk boundaries."""
    if chunk_bytes:
        # 5-row chunks, the last one partial
        monkeypatch.setattr(knn_mod, "_REFINE_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(31)
    q = rng.normal(size=(303, 5))
    # self mode on a perturbed copy: the own candidate's 0 comes from the
    # mask, not from a zero difference
    r = (q + 1e-6 * rng.normal(size=q.shape) if self_mode
         else rng.normal(size=(420, 5)))
    k_sel = 9
    idx = rng.integers(0, len(r), size=(len(q), k_sel))
    if self_mode:
        idx[:, 0] = np.arange(len(q))
    idx[rng.random(idx.shape) < 0.1] = -1
    want = knn_mod._refine_knn_f64_all(q, r, idx, self_mode)
    assert np.isinf(want).any() and (not self_mode or (want == 0).any())
    assert (knn_mod.refine_chunk_rows(k_sel, 5) == 5) == bool(chunk_bytes)
    got, n_thin = knn_mod.refine_knn_on_device(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(idx),
        k_sel, self_mode=self_mode)
    assert got.shape == (len(q), k_sel) and n_thin == 0
    np.testing.assert_allclose(got, want, rtol=REFINE_RTOL, atol=0)


@pytest.mark.parametrize("case", ["odd_lattice", "gaussian"])
def test_device_thin_count_matches_the_host_guard(case):
    """The device refine's thin count against the host guard's margin test,
    written out as it reads in the host guard, on the same candidates."""
    if case == "odd_lattice":
        x, k = _lattice(11).astype(np.float64), 2
    else:
        x, _ = synthetic_chain(3000, 8, seed=8)
        k = 5
    q_np, _ = knn_mod.center_f64(x)
    q32 = torch.as_tensor(q_np, dtype=torch.float32)
    idx = kh.knn_select_torch(q32, q32, k + 4, self_mode=True)[1]
    d_all = knn_mod._refine_knn_f64_all(q_np, q_np, idx.numpy(), True)
    boundary = d_all[:, -1]
    want = int(np.count_nonzero(
        (d_all[:, k - 1] > boundary * (1.0 - 2.0 ** -10))
        & np.isfinite(boundary) & (boundary > 0)))
    q64 = torch.from_numpy(q_np)
    got_d, got = knn_mod.refine_knn_on_device(q64, q64, idx, k,
                                              self_mode=True)
    assert got == want
    assert (want > 0) == (case == "odd_lattice")
    np.testing.assert_allclose(got_d, d_all[:, :k], rtol=REFINE_RTOL, atol=0)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_thin_rows_is_the_guards_margin(backend):
    """``thin_rows`` on numpy arrays and on tensors: the k-th distance
    within 2^-10 of a finite, positive boundary, and nothing else."""
    eps = 2.0 ** -10
    boundary = np.array([1.0, 1.0, 1.0, 4.0, np.inf, 0.0, np.nan, 2.0])
    kth = np.array([1 - 0.5 * eps, 1 - 1.5 * eps, 1.0, 4.0, 3.0, 0.0,
                    1.0, np.nan])
    want = [True, False, True, True, False, False, False, False]
    if backend == "torch":
        kth, boundary = torch.from_numpy(kth), torch.from_numpy(boundary)
    got = knn_mod.thin_rows(kth, boundary)
    assert np.asarray(got).tolist() == want


def _refine_dotp_post_inline(q64, r64, scal, idx, *, ndim, inv_s2, kmax,
                             self_mode, offset=0):
    """``pipeline._refine_dotp_post`` with its candidates' d2 written
    inline, as it read before it shared ``refined_d2_chunks``."""
    nq, k_sel = idx.shape
    dev = q64.device
    acc = torch.zeros(kmax, dtype=torch.float64, device=dev)
    thin = torch.zeros((), dtype=torch.float64, device=dev)
    rows = max(1, knn_mod._REFINE_CHUNK_BYTES
               // max(3 * k_sel * q64.shape[1] * 8, 1))
    for lo in range(0, nq, rows):
        hi = min(nq, lo + rows)
        ic = idx[lo:hi].long()
        diff = q64[lo:hi, None, :] - r64[ic.clamp(min=0)]
        d2 = (diff * diff).sum(-1).masked_fill(ic < 0, math.inf)
        if self_mode:
            own = torch.arange(offset + lo, offset + hi, device=dev)[:, None]
            d2 = d2.masked_fill(ic == own, 0.0)
        d2 = torch.sort(d2, dim=1).values
        if k_sel > kmax:
            kth, last = d2[:, kmax - 1], d2[:, -1]
            thin += ((kth > last * (1.0 - 2.0 ** -9)) & torch.isfinite(last)
                     & (last > 0)).sum()
        z = d2[:, :kmax] * inv_s2
        term = torch.pow(z, 0.5 * ndim) * scal[lo:hi, None]
        acc += torch.where(torch.isfinite(z), term, 0.0).sum(dim=0)
    return torch.cat([acc, thin[None]])


@pytest.mark.parametrize("chunk_bytes", [None, 20000])
@pytest.mark.parametrize("case", ["self", "cross", "self_shard"])
def test_device_refine_post_is_unchanged(case, chunk_bytes, monkeypatch):
    """The device precision's refine and reduction, now on the shared
    ``refined_d2_chunks``, equal to the inline formula bit for bit."""
    if chunk_bytes:
        monkeypatch.setattr(knn_mod, "_REFINE_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.normal(size=(1500, 8)))
    r64 = x if case != "cross" else torch.from_numpy(
        rng.normal(size=(1700, 8)))
    lo = 400 if case == "self_shard" else 0
    q64 = x[lo:lo + 700] if case == "self_shard" else x
    scal = torch.from_numpy(rng.random(len(q64)))
    q32, r32 = q64.to(torch.float32), r64.to(torch.float32)
    self_mode = case != "cross"
    # a shard of the query rows selects without the self pin
    idx = kh.knn_select_torch(q32, r32, 9, self_mode=case == "self")[1]
    kw = dict(ndim=8, inv_s2=3.7, kmax=5, self_mode=self_mode, offset=lo)
    got = pipeline._refine_dotp_post(q64, r64, scal, idx, **kw)
    assert torch.equal(got, _refine_dotp_post_inline(q64, r64, scal, idx,
                                                     **kw))


def _smalld_cases():
    rng = np.random.default_rng(37)
    out = {}
    for d in (1, 3, 6, 8, 16):
        x = rng.normal(size=(260, d)).astype(np.float32)
        out[f"self_d{d}"] = (x, x, True, None)
    q = rng.normal(size=(130, 7)).astype(np.float32)
    r = rng.normal(size=(700, 7)).astype(np.float32)
    garbage = np.concatenate([r[:300], np.full((100, 7), 1e8, np.float32)])
    dup = rng.normal(size=(200, 3)).astype(np.float32)
    dup[1::7] = dup[0::7][: len(dup[1::7])]
    out.update({
        "cross_d7": (q, r, False, None),
        "self_nr_garbage_d7": (garbage[:300], garbage, True, 300),
        "cross_nr_garbage_d7": (q, garbage, False, 300),
        "cross_k_gt_nr_d7": (q[:8], r[:64], False, 3),
        "self_duplicates_d3": (dup, dup, True, None),
    })
    return out


SMALLD_CASES = _smalld_cases()


@pytest.mark.parametrize("k", [9, 26])
@pytest.mark.parametrize("case", sorted(SMALLD_CASES))
def test_smalld_matches_pallas_k8(case, k):
    """The smalld wrapper (its plain version here) against K8 in interpret
    mode, fed as the JAX package feeds it: a width class padded with zero
    columns and ``d_real`` the true width."""
    query, ref, self_mode, nr = SMALLD_CASES[case]
    d = query.shape[1]
    width = 8 if d <= 8 else 16
    qp = np.zeros((len(query), width), np.float32)
    qp[:, :d] = query
    rp = qp if ref is query else np.zeros((len(ref), width), np.float32)
    rp[:, :d] = ref
    want = knn_select_pallas_smalld(jnp.asarray(qp), jnp.asarray(rp), k,
                                    self_mode=self_mode, interpret=True,
                                    nr=nr, d_real=d)
    kh.reset_launch_counts()
    got = kh.knn_select_smalld(torch.from_numpy(query), torch.from_numpy(ref),
                               k, self_mode=self_mode, nr=nr)
    assert kh.knn_select_smalld.launches == 0
    got = [t.numpy() for t in got]
    assert_same_selection(query, ref, *got, *want, self_mode=self_mode)
    if nr is not None:
        assert got[1].max() < nr


@pytest.mark.parametrize("k", [9, 44])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_smalld_batched_matches_pallas_k9(case, k):
    query, ref, self_mode, nr, nq = K5_CASES[case]
    want_d2, want_idx = (np.asarray(a) for a in
                         knn_select_pallas_smalld_batched(
                             jnp.asarray(query), jnp.asarray(ref), k,
                             self_mode=self_mode, interpret=True,
                             nr=np.asarray(nr, np.int32)))
    got_d2, got_idx = (a.numpy() for a in kh.knn_select_smalld(
        torch.from_numpy(query), torch.from_numpy(ref), k,
        self_mode=self_mode, nr=nr, nq=nq))
    assert got_d2.shape == (len(nr), query.shape[1], min(k, ref.shape[1]))
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        assert (got_idx[b, n_q:] == -1).all() and got_idx[b].max() < n_r
        assert_same_selection(query[b, :n_q], ref[b], got_d2[b, :n_q],
                              got_idx[b, :n_q], want_d2[b, :n_q],
                              want_idx[b, :n_q], self_mode=self_mode)


def test_smalld_wrapper_checks_its_inputs():
    x = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="nq"):
        kh.knn_select_smalld(x, x, 2, nq=[10])
    with pytest.raises(ValueError, match=r"\(Nq, d\)"):
        kh.knn_select_smalld(x, x[None], 2)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        exact_knn(np.zeros((10, 2)), None, 2)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build("knn_select")
    assert not list((tmp_path / "build").iterdir())


def _fake_nvcc(tmp_path, fail_on=None):
    """A stand-in nvcc that logs each call, waits a little and writes the
    file after ``-o``; it fails on a source whose path ends in ``fail_on``."""
    log = tmp_path / "calls"
    script = tmp_path / "fake_nvcc"
    fail = (f'  case "$1" in *{fail_on}) echo "error: {fail_on}" >&2; '
            'exit 3;; esac\n') if fail_on else ""
    script.write_text(
        "#!/bin/sh\n"
        f"echo x >> {log}\n"
        "sleep 0.3\n"
        "out=\n"
        "while [ $# -gt 0 ]; do\n"
        f"{fail}"
        "  if [ \"$1\" = -o ]; then shift; out=$1; fi\n"
        "  shift\n"
        "done\n"
        ": > \"$out\"\n")
    script.chmod(0o755)
    return script, log


def test_concurrent_builds_run_one_nvcc(monkeypatch, tmp_path):
    """Processes or threads that start building together wait on the lock
    beside each library and take the one build: one nvcc run a source, one
    library a source."""
    import threading
    script, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(_build.build()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert len(paths) == 3 and all(p == paths[0] for p in paths)
    assert sorted(paths[0]) == _build.sources()
    calls = log.read_text().split()
    assert len(calls) == len(_build.sources())     # one nvcc a source
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        os.path.basename(p) for p in paths[0].values())


def test_a_source_library_path_ignores_the_other_sources(monkeypatch,
                                                         tmp_path):
    """Each library is hashed on its own source, the headers and the flags:
    editing knn_wide.cu leaves knn_select.cu's library where it was, and
    editing a header moves both."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    select, wide = (_build.library_path(s) for s in ("knn_select",
                                                     "knn_wide"))
    assert os.path.basename(select).startswith("libknn_select_")
    with open(csrc / "knn_wide.cu", "a") as fh:
        fh.write("// an edit\n")
    assert _build.library_path("knn_select") == select
    assert _build.library_path("knn_wide") != wide
    wide = _build.library_path("knn_wide")
    with open(csrc / "knn_common.cuh", "a") as fh:
        fh.write("// an edit\n")
    assert _build.library_path("knn_select") != select
    assert _build.library_path("knn_wide") != wide
    with pytest.raises(ValueError, match="no CUDA source"):
        _build.library_path("knn_missing")


def test_every_entry_point_maps_to_the_one_source_that_defines_it():
    import re
    defined = {}
    for src in _build.sources():
        with open(os.path.join(_build.CSRC, f"{src}.cu")) as fh:
            for name in re.findall(r"^int (knn_\w+)\(", fh.read(), re.M):
                defined.setdefault(name, []).append(src)
    names = (_build.ENTRY_POINTS + _build.ENTRY_POINTS_EXTRA
             + _build.ENTRY_POINTS_WIDE)
    assert sorted(names) == sorted(_build.ENTRY_SOURCES) == sorted(defined)
    for name in names:
        assert defined[name] == [_build.ENTRY_SOURCES[name]]


def test_the_small_k_entry_points_alone_take_the_rechecks_counter_last():
    """``_build.ENTRY_POINTS_SMALL_K`` names exactly the C entry points
    whose last parameter is the rechecks counter, so ``_declare`` and
    ``knn_hopper._call`` pass it to those and to no others."""
    import re
    last = {}
    for src in _build.sources():
        with open(os.path.join(_build.CSRC, f"{src}.cu")) as fh:
            for name, params in re.findall(r"^int (knn_\w+)\(([^)]*)\)",
                                           fh.read(), re.M):
                last[name] = params.split(",")[-1].split()
    assert set(_build.ENTRY_POINTS_SMALL_K) <= set(last)
    for name, param in last.items():
        takes = param == ["unsigned", "long", "long*", "rechecks"]
        assert takes == (name in _build.ENTRY_POINTS_SMALL_K), name


def test_a_failed_source_leaves_the_others_loadable(monkeypatch, tmp_path):
    """knn_wide.cu fails to build: its entry points raise with nvcc's
    output, and the other sources still build and load."""
    script, _ = _fake_nvcc(tmp_path, fail_on="knn_wide.cu")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(os.path.basename(path))

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    with pytest.raises(RuntimeError, match="error: knn_wide.cu"):
        _build.build()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == sorted(os.path.basename(_build.library_path(s))
                           for s in _build.sources() if s != "knn_wide")
    with pytest.raises(RuntimeError, match="error: knn_wide.cu"):
        _build.load_entry("knn_select_wide")
    assert _build.load_entry("knn_select_small_k") is _build.load(
        "knn_select")
    _build.load_entry("knn_select_packed_large_k")
    assert _build.loaded() == ["knn_packed", "knn_select"]
    assert opened == [os.path.basename(_build.library_path(s))
                      for s in ("knn_select", "knn_packed")]


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_CASES) + ["lattice_k32"])
def test_kernels_match_plain_on_card(case, cuda_device):
    if case == "lattice_k32":
        query = ref = _lattice()
        k, self_mode, nr = 32, True, None
    else:
        query, ref, k, self_mode, nr = K1_CASES[case]
    q = torch.from_numpy(query).to(cuda_device)
    r = q if ref is query else torch.from_numpy(ref).to(cuda_device)
    want = [t.cpu() for t in kh.knn_select_torch(q, r, k,
                                                 self_mode=self_mode, nr=nr)]
    kh.reset_launch_counts()
    for wrapper in (kh.knn_select_small_k, kh.knn_select_large_k):
        if wrapper is kh.knn_select_small_k and k > kh.SMALL_K_MAX:
            continue
        got = [t.cpu() for t in wrapper(q, r, k, self_mode=self_mode, nr=nr)]
        torch.cuda.synchronize()
        assert wrapper.launches == 1
        assert_same_selection(query, ref, *want, *got, self_mode=self_mode)


@pytest.mark.cuda
def test_exact_knn_on_card_matches_reference(cuda_device):
    query, _, k = _knn_inputs(np.random.default_rng(5), "lattice")
    kh.reset_launch_counts()
    got = exact_knn(query, None, k, device=cuda_device)
    np.testing.assert_allclose(got, jax_exact_knn(query, None, k,
                                                  engine="xla"),
                               rtol=0, atol=1e-12)
    assert kh.knn_select_small_k.launches == 1
    assert kh.knn_select_large_k.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 9, 26, 106])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_batched_kernel_matches_plain_on_card(case, k, cuda_device):
    query, ref, self_mode, nr, nq = K5_CASES[case]
    q = torch.from_numpy(query).to(cuda_device)
    r = q if ref is query else torch.from_numpy(ref).to(cuda_device)
    want = [t.cpu() for t in kh.knn_select_torch_batched(
        q, r, k, self_mode=self_mode, nr=nr, nq=nq)]
    kh.reset_launch_counts()
    got = [t.cpu() for t in kh.knn_select_batched(
        q, r, k, self_mode=self_mode, nr=nr, nq=nq)]
    torch.cuda.synchronize()
    assert kh.knn_select_batched.launches == 1
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        assert (got[1][b, n_q:] == -1).all()
        assert int(got[1][b].max()) < n_r
        assert_same_selection(query[b, :n_q], ref[b],
                              want[0][b, :n_q], want[1][b, :n_q],
                              got[0][b, :n_q], got[1][b, :n_q],
                              self_mode=self_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 9, 13, 14, 44, 106])
@pytest.mark.parametrize("case", sorted(SMALLD_CASES))
def test_smalld_kernel_matches_plain_on_card(case, k, cuda_device):
    query, ref, self_mode, nr = SMALLD_CASES[case]
    q = torch.from_numpy(query).to(cuda_device)
    r = q if ref is query else torch.from_numpy(ref).to(cuda_device)
    want = [t.cpu() for t in kh.knn_select_torch(q, r, k,
                                                 self_mode=self_mode, nr=nr)]
    kh.reset_launch_counts()
    got = [t.cpu() for t in kh.knn_select_smalld(q, r, k,
                                                 self_mode=self_mode, nr=nr)]
    torch.cuda.synchronize()
    assert kh.knn_select_smalld.launches == 1
    assert_same_selection(query, ref, *want, *got, self_mode=self_mode)
    # exact f32 differences in another order: the returned d2 within a few
    # ulps of the plain version's
    fin = torch.isfinite(want[0])
    assert torch.allclose(got[0][fin], want[0][fin], rtol=2.0 ** -18,
                          atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 26, 106])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_smalld_batched_kernel_matches_plain_on_card(case, k, cuda_device):
    query, ref, self_mode, nr, nq = K5_CASES[case]
    q = torch.from_numpy(query).to(cuda_device)
    r = q if ref is query else torch.from_numpy(ref).to(cuda_device)
    want = [t.cpu() for t in kh.knn_select_torch_batched(
        q, r, k, self_mode=self_mode, nr=nr, nq=nq)]
    kh.reset_launch_counts()
    got = [t.cpu() for t in kh.knn_select_smalld(
        q, r, k, self_mode=self_mode, nr=nr, nq=nq)]
    torch.cuda.synchronize()
    assert kh.knn_select_smalld.launches == 1
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        assert (got[1][b, n_q:] == -1).all()
        assert int(got[1][b].max()) < n_r
        assert_same_selection(query[b, :n_q], ref[b],
                              want[0][b, :n_q], want[1][b, :n_q],
                              got[0][b, :n_q], got[1][b, :n_q],
                              self_mode=self_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 20])
def test_exact_dispatch_returned_d2_on_card(k, cuda_device):
    """The fast precision consumes the kernels' d2: within a few ulps of
    the plain version's on the same inputs."""
    query, ref, _, self_mode, nr = K1_CASES["cross"]
    q = torch.from_numpy(query).to(cuda_device)
    r = torch.from_numpy(ref).to(cuda_device)
    want = kh.knn_select_torch(q, r, k)[0].cpu()
    got = kh.knn_select_cuda(q, r, k)[0].cpu()
    assert torch.allclose(got, want, rtol=2.0 ** -18, atol=0.0)
