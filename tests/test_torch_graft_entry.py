"""The port's entry module (``mcevidence_tpu_torch/graft_entry.py``) against
the repository's ``__graft_entry__.py``.

``entry()`` runs on the CPU on the same chain as JAX's ``entry()``, held
at the fast gate (f32 whitening and estimator; the port takes d2 by
differences, JAX's XLA selection by the matrix identity).
``dryrun_multichip`` runs on 3 and 4 gloo ranks of the CPU; every rank's
answers must agree and each must sit within its gate of the one-device
estimate (the asserts inside the ranks).
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jax_entry
from mcevidence_tpu_torch import graft_entry


def test_entry_matches_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32
               and a.device.type == "cpu" for a in args)
    out = fn(*args).numpy()
    assert out.shape == (5,)
    assert np.all(np.isfinite(out[1:]))
    assert abs(out[1]) < 0.5       # lnZ ~ 0 for the synthetic chain
    jfn, jargs = jax_entry.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), b)
    want = np.asarray(jax.jit(jfn)(*jargs))
    np.testing.assert_allclose(out[1:], want[1:], rtol=0, atol=3e-3)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)


def test_dryrun_refuses_nccl_on_shared_or_host_devices(monkeypatch):
    """NCCL needs a card a rank: ranks on the host, or two ranks on one
    card, raise naming gloo before any rank starts."""
    with pytest.raises(ValueError, match="gloo"):
        graft_entry.dryrun_multichip(2, device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share"):
        graft_entry.dryrun_multichip(2, backend="nccl")


@pytest.mark.parametrize("n", [3, 4])
def test_dryrun_multichip_on_cpu_ranks(n):
    got = graft_entry.dryrun_multichip(n, device="cpu", timeout=300)
    assert got["ran_on"] == "cpu"
    gaps = got["max_abs_dlnz_vs_one_card"]
    want = {"auto_fast", "cross_fast", "auto_refine", "auto_device"}
    if n == 4:
        want |= {"grid_fast", "grid_device", "grid_cross_refine"}
        assert np.asarray(got["grid"]).shape == (3, 2)
    assert set(gaps) == want
    for key, gap in gaps.items():
        assert gap <= (3e-3 if key.endswith("fast") else 1e-8), key
    assert np.all(np.isfinite(got["refine"]))
