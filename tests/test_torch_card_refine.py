"""The refine precision's f64 refine on the card (``ops/knn.py``).

``exact_knn(refine=True)`` selects, refines and tests the margin on the
selection's device, and fetches only the k sorted distances.  These tests
hold it, on the card, to the host refine and guard
(``guarded_refine_knn_f64``) of the card's own indices, and the refine
precision to the device precision, and the device precision's
thin-margin re-run from the first pass's uploads to a pass prepped afresh.
They are marked ``cuda`` and skip without a card.  No JAX here: the card's
answers are held to the port's own host path.
"""

import itertools
import logging

import numpy as np
import pytest
import torch

from mcevidence_tpu_torch import MCEvidence
from mcevidence_tpu_torch.bench import synthetic_chain
from mcevidence_tpu_torch.ops import knn as knn_mod

# the card sums over d in another order than numpy's einsum
REFINE_RTOL = 2e-15
# refine against device in ln Z, as on the card at 2^20 rows
REFINE_VS_DEVICE = 6.4e-14


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(case):
    """(query, ref or None, k): a whitened-scale Gaussian chain, a cross
    pair, and the odd lattice whose exact ties make the guard re-select."""
    rng = np.random.default_rng(23)
    if case == "self":
        return rng.normal(size=(20000, 8)), None, 5
    if case == "cross":
        return rng.normal(size=(12000, 8)), rng.normal(size=(30000, 8)), 5
    lattice = np.array(list(itertools.product(range(11), repeat=3)),
                       np.float64)
    return lattice, None, 2


def _host_refine_of_card_indices(query, ref, k, dev, pad=4):
    """The host composition on the card's indices: f32 cast on the host,
    the refine engine's selection on ``dev``, the numpy refine and
    guard."""
    self_mode = ref is None
    q_np, r_np = knn_mod.center_f64(query, ref)
    q32 = torch.as_tensor(q_np, dtype=torch.float32).to(dev)
    r32 = q32 if self_mode else torch.as_tensor(
        r_np, dtype=torch.float32).to(dev)
    sel = knn_mod.selector("auto", "refine", width=query.shape[1])

    def select(ks):
        return sel(q32, r32, ks, self_mode=self_mode)[1].cpu().numpy()
    return knn_mod.guarded_refine_knn_f64(q_np, r_np, select(k + pad), k,
                                          self_mode=self_mode,
                                          reselect=select)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self", "cross", "odd_lattice"])
def test_card_refine_matches_the_host_refine_of_its_indices(case,
                                                            cuda_device,
                                                            caplog):
    query, ref, k = _inputs(case)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu_torch.ops.knn"):
        got = knn_mod.exact_knn(query, ref, k, device=cuda_device)
    retried = [r for r in caplog.records
               if "re-selecting with 32 candidates" in r.getMessage()]
    # the lattice's ties make the guard fire, once
    assert len(retried) == (1 if case == "odd_lattice" else 0)
    want = _host_refine_of_card_indices(query, ref, k, cuda_device)
    assert got.shape == want.shape == (len(query), k)
    np.testing.assert_allclose(got, want, rtol=REFINE_RTOL, atol=0)


@pytest.mark.cuda
def test_refine_matches_device_precision_on_a_65k_chain(cuda_device):
    theta, lnl = synthetic_chain(65536, 8, seed=5)
    src = {"samples": theta, "loglikes": lnl}
    got = {p: MCEvidence(src, kmax=5, precision=p, device=cuda_device,
                         verbose=0).evidence()
           for p in ("refine", "device")}
    assert np.isfinite(got["refine"]).all()
    assert np.abs(got["refine"] - got["device"]).max() <= REFINE_VS_DEVICE


@pytest.mark.cuda
def test_thin_rows_rerun_on_the_card_from_the_first_uploads(cuda_device):
    """Planted thin rows (a row and ten exact copies of a point at
    distance 1, far out in a Gaussian's tails): the estimate counts them,
    preps and uploads once, and its re-run agrees with a pass prepped
    afresh at the retry's candidates."""
    from mcevidence_tpu_torch.ops import pipeline
    rng = np.random.default_rng(11)
    theta = rng.standard_normal((20000, 8))
    planted = []
    for j in range(3):
        q = np.zeros(8)
        q[j] = 7.0
        u = rng.standard_normal(8)
        planted += [q[None], np.repeat((q + u / np.linalg.norm(u))[None],
                                       10, axis=0)]
    samples = np.vstack([theta, *planted])
    lnl = -0.5 * np.sum(samples * samples, axis=1)
    mce = MCEvidence({"samples": samples, "loglikes": lnl}, kmax=5,
                     precision="device", device=cuda_device, verbose=0)
    got = mce.evidence()
    assert mce.timings["thin_rows"] == 3
    names = [s[0] for s in mce.spans]
    assert names.count("device_prep") == names.count("upload") == 1
    assert names.count("device_run") == 2
    flat, _, plan = pipeline.device_refine_launch(
        samples, lnl, kmax=5, pad_candidates=24, device=cuda_device,
        wait=True)
    fresh = pipeline.device_refine_finish(flat, plan, last=True)
    np.testing.assert_allclose(got, fresh, rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [26, 64, 65])
def test_wide_chains_take_the_device_path_on_the_card(ndim, cuda_device):
    """Up to the kernels' 64 columns the device precision runs on the card
    (the ``Padded<32>`` and ``<64>`` selections, then the f64 refine and
    reduction) and counts no fallback; 65 columns fall back, counted.
    Either way it agrees with the refine precision on the card."""
    rng = np.random.default_rng(ndim)
    theta = rng.standard_normal((16384, ndim)) @ (
        np.eye(ndim) + 0.1 * rng.standard_normal((ndim, ndim)))
    lnl = -0.5 * np.sum(theta * theta, axis=1)
    chain = {"samples": theta, "loglikes": lnl}
    mce = MCEvidence(chain, kmax=2, precision="device", device=cuda_device,
                     verbose=0)
    got = mce.evidence()
    assert mce.timings["device_fallbacks"] == (ndim > 64)
    assert ("device_run_s" in mce.timings) == (ndim <= 64)
    ref = MCEvidence(chain, kmax=2, precision="refine", device=cuda_device,
                     verbose=0).evidence()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
