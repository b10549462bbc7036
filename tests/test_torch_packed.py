"""The port's packed selections and the engine map against the JAX package.

On the CPU ``knn_select_packed`` and ``knn_select_prologue`` run their plain
version, ``knn_select_torch(low_bits=...)``.  It is held to the Pallas
kernels it stands for, run in interpret mode as the JAX package's own tests
run them: K6 (``knn_select_pallas_packed``) and K7
(``knn_select_pallas_packed_batched``) at 11 low bits, K1
(``knn_select_pallas_packed2``) at 12, and the prologue study S1
(``scripts/bench_prologue.py:knn_variant``, variants AB and ABC) at 12.
Criteria: the f64 d2 at the returned indices within 2^-10 of the plain
version's (``assert_same_selection``); the returned d2, which the ``fast``
precision consumes, within one quantum (2^-11 relative) plus the TPU
kernels' matrix-identity rounding (``K4_ULPS``) of the plain version's; the
truncated bits of every returned d2 zero; and the indices equal, slot for
slot, wherever the k+1 nearest are not near-tied.  On an integer lattice of
odd side (exact centring, exact d2, exact ties) the indices are equal on
every row.  The tests marked ``cuda`` hold the kernels to the plain version
on the card and skip elsewhere.
"""

import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from mcevidence_tpu.ops.knn_pallas import (knn_select_pallas_packed,
                                           knn_select_pallas_packed2,
                                           knn_select_pallas_packed_batched)
from mcevidence_tpu_torch.ops import knn_hopper as kh
from mcevidence_tpu_torch.ops.knn import ENGINES, PATHS, selector
# by its basename, as pytest imports the test files of this directory: a
# package named ``tests`` elsewhere on the path cannot shadow it
from test_torch_knn import (K1_CASES, K4_ULPS, K5_CASES,  # noqa: E402
                            assert_same_selection)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def odd_lattice(side=11):
    """side^3 integer points, side odd: the centring mean is an integer, so
    every d2 is an exact integer in f32 on both sides and ties are exact."""
    return np.array(list(itertools.product(range(side), repeat=3)),
                    np.float32)


def _plain(query, ref, k, self_mode, nr, low_bits):
    return [t.numpy() for t in kh.knn_select_torch(
        torch.from_numpy(query), torch.from_numpy(ref), k,
        self_mode=self_mode, nr=nr, low_bits=low_bits)]


def _unambiguous(query, ref, k, self_mode, nr):
    """Rows whose k+1 nearest exact d2 are separated by more than two
    quanta of 12 low bits: every truncated ranking orders them alike."""
    d2 = _plain(query, ref, k + 1, self_mode, nr, 0)[0].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = d2[:, 1:] / d2[:, :-1]
    return ((ratio > 1 + 2.0 ** -10) | np.isinf(d2[:, 1:])).all(axis=1)


def assert_packed_match(query, ref, k, self_mode, nr, low_bits, want,
                        got=None, all_rows=False):
    """``want``: the TPU kernel's (d2, idx); ``got``: the port's (default
    its plain version)."""
    want_d2, want_idx = (np.asarray(a) for a in want)
    got_d2, got_idx = got or _plain(query, ref, k, self_mode, nr, low_bits)
    assert_same_selection(query, ref, got_d2, got_idx, want_d2, want_idx,
                          self_mode=self_mode)
    low = (1 << low_bits) - 1
    for d2 in (got_d2, want_d2):
        fin = np.isfinite(d2)
        assert not (d2[fin].view(np.int32) & low).any()
    # returned d2: one quantum (the kernels round their sums differently)
    # plus the matrix identity's rounding of |q|^2 + |r|^2
    n_ref = ref.shape[0] if nr is None else nr
    mu = ref[:n_ref].astype(np.float64).mean(axis=0)
    scale = (np.sum((query - mu) ** 2, axis=1, keepdims=True)
             + np.max(np.sum((ref[:n_ref] - mu) ** 2, axis=1)))
    fin = np.isfinite(got_d2)
    err = np.abs(want_d2.astype(np.float64)[fin] - got_d2[fin])
    tol = (2.0 ** -11 * got_d2.astype(np.float64)
           + K4_ULPS * np.broadcast_to(scale, fin.shape))[fin]
    assert (err <= tol).all()
    rows = (np.ones(len(query), bool) if all_rows
            else _unambiguous(query, ref, k, self_mode, nr))
    np.testing.assert_array_equal(got_idx[rows], want_idx[rows])
    if nr is not None:
        assert got_idx.max() < nr
    return int(rows.sum())


PACKED_KERNELS = {11: knn_select_pallas_packed, 12: knn_select_pallas_packed2}


@pytest.mark.parametrize("low_bits", [11, 12], ids=["k6", "k1"])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_plain_packed_matches_pallas(case, low_bits):
    query, ref, k, self_mode, nr = K1_CASES[case]
    want = PACKED_KERNELS[low_bits](jnp.asarray(query), jnp.asarray(ref), k,
                                    self_mode=self_mode, interpret=True,
                                    nr=nr)
    checked = assert_packed_match(query, ref, k, self_mode, nr, low_bits,
                                  want)
    if case in ("self", "cross"):
        assert checked > 0.5 * len(query)


@pytest.mark.parametrize("low_bits", [11, 12], ids=["k6", "k1"])
@pytest.mark.parametrize("k", [7, 20, 33])
def test_plain_packed_matches_pallas_on_tied_lattice(k, low_bits):
    """Exact ties everywhere: the index must break them as the TPU kernels
    do, slot for slot on every row (``topk`` on truncated floats would
    not)."""
    x = odd_lattice()
    want = PACKED_KERNELS[low_bits](jnp.asarray(x), jnp.asarray(x), k,
                                    self_mode=True, interpret=True)
    assert_packed_match(x, x, k, True, None, low_bits, want, all_rows=True)


@pytest.mark.parametrize("k", [6, 26])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_plain_packed_batched_matches_pallas_k7(case, k):
    query, ref, self_mode, nr, nq = K5_CASES[case]
    want_d2, want_idx = (np.asarray(a) for a in
                         knn_select_pallas_packed_batched(
                             jnp.asarray(query), jnp.asarray(ref), k,
                             self_mode=self_mode, interpret=True,
                             nr=np.asarray(nr, np.int32)))
    kh.reset_launch_counts()
    got_d2, got_idx = (a.numpy() for a in kh.knn_select_packed(
        torch.from_numpy(query), torch.from_numpy(ref), k, low_bits=11,
        self_mode=self_mode, nr=nr, nq=nq))
    assert kh.knn_select_packed.launches == 0
    assert got_d2.shape == (len(nr), query.shape[1], min(k, ref.shape[1]))
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        assert (got_idx[b, n_q:] == -1).all()
        assert np.isinf(got_d2[b, n_q:]).all()
        assert_packed_match(query[b, :n_q], ref[b], k, self_mode, n_r, 11,
                            (want_d2[b, :n_q], want_idx[b, :n_q]),
                            got=(got_d2[b, :n_q], got_idx[b, :n_q]))


def _bench_prologue():
    spec = importlib.util.spec_from_file_location(
        "bench_prologue", os.path.join(ROOT, "scripts", "bench_prologue.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("variant", ["B", "BC"])
def test_plain_prologue_matches_bench_prologue(variant, k):
    """S1's variants AB and ABC (cut A has no counterpart here) against the
    port's B and BC, self mode, at N = 700 (not a multiple of 128)."""
    x = np.random.default_rng(41).normal(size=(700, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _bench_prologue().knn_variant(jnp.asarray(x), jnp.asarray(x),
                                             k, "A" + variant)
    kh.reset_launch_counts()
    got = [t.numpy() for t in kh.knn_select_prologue(
        torch.from_numpy(x), torch.from_numpy(x), k, variant=variant)]
    assert kh.knn_select_prologue.launches == 0
    assert_packed_match(x, x, k, True, None, 12, want, got=got)


def test_plain_prologue_sentinel_slots_are_absent():
    x = np.random.default_rng(43).normal(size=(50, 4)).astype(np.float32)
    d2, idx = kh.knn_select_prologue(torch.from_numpy(x[:10]),
                                     torch.from_numpy(x), 6, nr=4,
                                     self_mode=False)
    assert (idx[:, 4:] == -1).all() and torch.isinf(d2[:, 4:]).all()
    assert (idx[:, :4] >= 0).all() and torch.isfinite(d2[:, :4]).all()


def test_packed_wrappers_check_their_inputs():
    x = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="low_bits"):
        kh.knn_select_packed(x, x, 2, low_bits=10)
    with pytest.raises(ValueError, match="nq"):
        kh.knn_select_packed(x, x, 2, nq=[10])
    with pytest.raises(ValueError, match="variant"):
        kh.knn_select_prologue(x, x, 2, variant="ABC")
    with pytest.raises(ValueError, match="f32"):
        kh.knn_select_torch(x.double(), x.double(), 2, low_bits=11)


# --- the engine map -------------------------------------------------------

def _packed(low_bits):
    return ("packed", low_bits)


EXACT = {"refine": kh.knn_select_cuda, "fast": kh.knn_select_cuda,
         "device": kh.knn_select_cuda, "batched": kh.knn_select_batched,
         "grid_fast": kh.knn_select_batched}
ENGINE_MAP = {
    "auto": EXACT, "cuda": EXACT, "pallas": EXACT, "pallas_exact": EXACT,
    "pallas_smalld": dict(EXACT, refine=kh.knn_select_smalld,
                          device=kh.knn_select_smalld,
                          batched=kh.knn_select_smalld),
    "pallas_packed": dict(EXACT, refine=_packed(11), fast=_packed(11),
                          device=_packed(11), batched=_packed(11)),
    "pallas_packed2": dict(EXACT, refine=_packed(12), fast=_packed(12),
                           device=_packed(12)),
    "pallas_binned": dict(EXACT, refine=kh.knn_select_large_k,
                          fast=kh.knn_select_large_k, device=_packed(12)),
    "torch": dict.fromkeys(PATHS, kh.knn_select_torch),
    "xla": dict.fromkeys(PATHS, kh.knn_select_torch),
}
for _torch in ("torch", "xla"):
    ENGINE_MAP[_torch].update(batched=kh.knn_select_torch_batched,
                              grid_fast=kh.knn_select_torch_batched)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_selector_follows_the_engine_map(engine, path):
    """mcevidence_tpu/ops/knn.py:316-356, pipeline.py:55-67, 271-291 and
    332-357, parallel/ring.py:1050-1071 and planck.py:468, path by path."""
    want = ENGINE_MAP[engine][path]
    got = selector(engine, path, width=8)
    if isinstance(want, tuple):
        assert got.func is kh.knn_select_packed
        assert got.keywords == {"low_bits": want[1]}
    else:
        assert got is want


def test_selector_rejects_unknown_paths():
    with pytest.raises(ValueError, match="unknown path"):
        selector("auto", "grid", width=8)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _on_card(query, ref, dev):
    q = torch.from_numpy(query).to(dev)
    return q, (q if ref is query else torch.from_numpy(ref).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 13, 20, 106])
@pytest.mark.parametrize("low_bits", [11, 12])
@pytest.mark.parametrize("case", sorted(K1_CASES) + ["lattice"])
def test_packed_kernel_matches_plain_on_card(case, low_bits, k, cuda_device):
    if case == "lattice":
        query = ref = odd_lattice()
        self_mode, nr = True, None
    else:
        query, ref, _, self_mode, nr = K1_CASES[case]
    q, r = _on_card(query, ref, cuda_device)
    want = [t.cpu().numpy() for t in kh.knn_select_torch(
        q, r, k, self_mode=self_mode, nr=nr, low_bits=low_bits)]
    kh.reset_launch_counts()
    got = [t.cpu().numpy() for t in kh.knn_select_packed(
        q, r, k, low_bits=low_bits, self_mode=self_mode, nr=nr)]
    torch.cuda.synchronize()
    assert kh.knn_select_packed.launches == 1
    assert_packed_match(query, ref, k, self_mode, nr, low_bits, want,
                        got=got, all_rows=case == "lattice")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 26, 106])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_packed_batched_kernel_matches_plain_on_card(case, k, cuda_device):
    query, ref, self_mode, nr, nq = K5_CASES[case]
    q, r = _on_card(query, ref, cuda_device)
    want = [t.cpu().numpy() for t in kh.knn_select_torch_batched(
        q, r, k, self_mode=self_mode, nr=nr, nq=nq, low_bits=11)]
    kh.reset_launch_counts()
    got = [t.cpu().numpy() for t in kh.knn_select_packed(
        q, r, k, self_mode=self_mode, nr=nr, nq=nq)]
    torch.cuda.synchronize()
    assert kh.knn_select_packed.launches == 1
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        assert (got[1][b, n_q:] == -1).all()
        assert_packed_match(query[b, :n_q], ref[b], k, self_mode, n_r, 11,
                            (want[0][b, :n_q], want[1][b, :n_q]),
                            got=(got[0][b, :n_q], got[1][b, :n_q]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 9])
@pytest.mark.parametrize("variant", ["B", "BC"])
def test_prologue_kernel_matches_plain_on_card(variant, k, cuda_device):
    x = np.random.default_rng(41).normal(size=(1000, 8)).astype(np.float32)
    q = torch.from_numpy(x).to(cuda_device)
    want = [t.cpu().numpy()
            for t in kh.knn_select_prologue_torch(q, q, k)]
    kh.reset_launch_counts()
    got = [t.cpu().numpy()
           for t in kh.knn_select_prologue(q, q, k, variant=variant)]
    torch.cuda.synchronize()
    assert kh.knn_select_prologue.launches == 1
    assert_packed_match(x, x, k, True, None, 12, want, got=got)
