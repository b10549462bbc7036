"""The refine precision's f64 refine on the card (``ops/knn.py``).

``exact_knn(refine=True)`` selects, refines and tests the margin on the
selection's device, and fetches only the k sorted distances.  These tests
hold it, on the card, to the host refine and guard
(``guarded_refine_knn_f64``) of the card's own indices, and the refine
precision to the device precision.  They are marked ``cuda`` and skip
without a card.  No JAX here: the card's answers are held to the port's
own host path.
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
