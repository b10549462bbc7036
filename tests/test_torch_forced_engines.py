"""The forced engines ``pallas_packed``, ``pallas_packed2`` and
``pallas_binned`` end to end, the port against the JAX package.

The JAX side runs its Pallas kernels under
``pltpu.force_tpu_interpret_mode()``; the port runs on ``device="cpu"``,
where its kernel wrappers take their plain versions.  ``refine`` and
``device`` are held at 1e-9 in ln Z, ``fast`` at 1e-4: under the packed
engines ``fast`` consumes the truncated d2 on both sides, which moves it
by ~2e-4 from the exact selection's answer, so an exact stand-in would not
meet the tolerance.  The grid's ``-nc 4 --engine pallas_packed`` tables are
held at 1e-8.
"""

import logging

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu
from mcevidence_tpu import MCEvidence as JaxMCEvidence
from mcevidence_tpu import evidence_fn as jax_evidence_fn
from mcevidence_tpu.ops.knn import exact_knn as jax_exact_knn
from mcevidence_tpu_torch import MCEvidence, evidence_fn
from mcevidence_tpu_torch.ops import knn_hopper as kh
from mcevidence_tpu_torch.ops.knn import exact_knn
from tests.conftest import make_gaussian_chain
from test_torch_packed import odd_lattice  # noqa: E402

FORCED = ("pallas_packed", "pallas_packed2", "pallas_binned")
ATOL = {"refine": 1e-9, "device": 1e-9, "fast": 1e-4}


@pytest.fixture(scope="module")
def chain():
    return make_gaussian_chain(np.random.default_rng(8), n=1500, ndim=4)


def _jax(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kw)


@pytest.mark.parametrize("precision", ["refine", "device", "fast"])
@pytest.mark.parametrize("engine", FORCED)
def test_evidence_fn_forced_engine_matches_reference(chain, engine,
                                                     precision):
    theta, lnl = chain
    want = _jax(jax_evidence_fn, theta, lnl, kmax=5, precision=precision,
                engine=engine)
    kh.reset_launch_counts()
    got = evidence_fn(theta, lnl, kmax=5, precision=precision, engine=engine,
                      device="cpu")
    assert kh.knn_select_packed.launches == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[precision])
    if precision == "fast" and engine != "pallas_binned":
        # the truncation is what meets the tolerance
        exact = evidence_fn(theta, lnl, kmax=5, precision="fast",
                            device="cpu")
        assert np.abs(exact - want).max() > 3 * np.abs(got - want).max()


@pytest.mark.parametrize("precision", ["refine", "fast"])
@pytest.mark.parametrize("engine", FORCED)
def test_cross_evidence_forced_engine_matches_reference(chain, engine,
                                                        precision):
    theta, lnl = chain
    want = _jax(jax_evidence_fn, theta[:700], lnl[:700],
                samples2=theta[700:], kmax=4, precision=precision,
                engine=engine)
    got = evidence_fn(theta[:700], lnl[:700], samples2=theta[700:], kmax=4,
                      precision=precision, engine=engine, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[precision])


@pytest.mark.parametrize("engine", FORCED)
def test_mcevidence_fused_fast_forced_engine_matches_reference(chain,
                                                               engine):
    """MCEvidence's fused fast program (pipeline.py:55-67) under each forced
    engine."""
    theta, lnl = chain
    src = {"samples": theta, "loglikes": lnl}
    want = _jax(lambda: JaxMCEvidence(src, kmax=5, verbose=0,
                                      precision="fast",
                                      engine=engine).evidence())
    mce = MCEvidence(src, kmax=5, verbose=0, precision="fast", engine=engine,
                     device="cpu")
    got = mce.evidence()
    assert "fused_s" in mce.timings
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL["fast"])


@pytest.mark.parametrize("engine", ["pallas_packed", "pallas_packed2"])
def test_unrefined_packed_engines_return_truncated_distances(engine):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(400, 5))
    got = exact_knn(x, None, 4, refine=False, engine=engine, device="cpu")
    low_bits = 11 if engine == "pallas_packed" else 12
    xc = torch.as_tensor(x - x.mean(axis=0), dtype=torch.float32)
    d2 = kh.knn_select_torch(xc, xc, 4, self_mode=True,
                             low_bits=low_bits)[0]
    np.testing.assert_array_equal(got, np.sqrt(d2.double().numpy()))
    want = _jax(jax_exact_knn, x, None, 4, refine=False, engine=engine)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -12, atol=1e-6)


@pytest.mark.parametrize("engine", FORCED)
def test_refine_guard_retries_under_forced_engines(engine, caplog):
    """The guard's 2^-10 margin still sees the lattice's ties through 11-
    and 12-bit truncation: one retry with 4*6+8 = 32 candidates, which
    takes the large-k body."""
    x = odd_lattice().astype(np.float64)
    with caplog.at_level(logging.INFO,
                         logger="mcevidence_tpu_torch.ops.knn"):
        got = exact_knn(x, None, 2, engine=engine, device="cpu")
    want = jax_exact_knn(x, None, 2, engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    retried = [r for r in caplog.records
               if "re-selecting with 32 candidates" in r.getMessage()]
    assert len(retried) == 1


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    """tests/test_planck.py's mini grid with four chain files per cell."""
    from tests.test_planck import _write_chain
    from tests.test_torch_planck import DS
    root = tmp_path_factory.mktemp("grid4")
    rng = np.random.default_rng(12345)
    for model, ndim in [("base", 4), ("base_w", 5)]:
        d = root / model / DS
        d.mkdir(parents=True)
        _write_chain(str(d / f"{model}_{DS}"), rng, ndim, n=300, nchains=4)
    return str(root)


@pytest.mark.parametrize("nchain", [4, 0], ids=["nc4", "allchains"])
def test_grid_pallas_packed_matches_reference(grid4, nchain):
    """The grid at its defaults (device precision, batched cells) under
    ``--engine pallas_packed``: ``-nc 4`` takes K7's counterpart on each
    batch, AllChains K6's on each cell.  The JAX driver's batched program
    calls its Pallas kernel inside ``shard_map`` over the CPU mesh, where
    interpret mode does not run, so the port is held to the JAX driver's
    tables on its plain selection: at 1e-8 to its batched program
    (tests/test_torch_planck.py says why) and at 1e-9 to its per-cell
    path."""
    from mcevidence_tpu import planck as jax_planck
    from mcevidence_tpu_torch import planck
    from tests.test_torch_planck import (ATOL_JAX_GRID, DS,
                                         assert_same_table)
    kw = dict(kmax=3, verbose=0, nchain=nchain, precision="device")
    kh.reset_launch_counts()
    got = planck.dataset_evidence(grid4, DS, batch_cells=True,
                                  engine="pallas_packed", device="cpu", **kw)
    assert kh.knn_select_packed.launches == 0
    want = jax_planck.dataset_evidence(grid4, DS, batch_cells=True,
                                       engine="xla", **kw)
    assert_same_table(got, want, atol=ATOL_JAX_GRID)
    want = jax_planck.dataset_evidence(grid4, DS, batch_cells=False,
                                       engine="xla", **kw)
    assert_same_table(got, want)
