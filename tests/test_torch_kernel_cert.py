"""The port's kernel cert (``mcevidence_tpu_torch.kernel_cert``) on the CPU.

Every leg runs at N=512, d=8, k=9 with the plain versions (the wrappers'
path for CPU tensors).  The selections the legs make are recorded and held
to JAX's ``knn_select_xla`` on the same inputs, as
``scripts/tpu_kernel_cert.py`` holds the TPU kernels: the d2 recomputed in
f64 at the returned indices, sorted, within 2^-10 relative of the
reference's sorted d2 (``REL_TOL``).  A wrong index must fail its check and
the run must exit 1.
"""

import contextlib
import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcevidence_tpu.ops.knn import knn_select_xla
from mcevidence_tpu_torch import kernel_cert
from mcevidence_tpu_torch.kernel_bench import KERNELS
from mcevidence_tpu_torch.ops import knn_hopper as kh

SHAPE = (512, 8, 9)


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = kernel_cert.main(argv)
    return rc, out.getvalue().splitlines()


def test_every_wrapper_has_legs_and_every_leg_passes():
    legs = kernel_cert.cert_legs(*SHAPE, "cpu")
    assert {wname for _, wname, _ in legs} == set(KERNELS)
    names = [name for name, _, _ in legs]
    assert len(set(names)) == len(names)
    # self, cross, the batched forms and the retry leg at k = 26
    for part in ("/self", "/cross", "_batched/self", "@k26"):
        assert any(part in nm for nm in names), part
    rc, lines = run([str(a) for a in SHAPE] + ["--device", "cpu"])
    assert rc == 0
    checks = [ln for ln in lines if ln.startswith(("PASS", "FAIL"))]
    assert len(checks) == len(legs)
    assert all(ln.startswith("PASS") for ln in checks)
    assert lines[-1] == f"ALL PASS: {len(legs)} checks on cpu"


def _d2_rel_to_xla(query, ref, idx, k, self_mode, nr):
    """f64 d2 at the returned indices against knn_select_xla's d2, both
    sorted (scripts/tpu_kernel_cert.py's _check)."""
    q = query.double().numpy()
    r = ref.double().numpy()
    if self_mode:
        want, _ = knn_select_xla(jnp.asarray(r[:nr]), jnp.asarray(r[:nr]), k,
                                 self_mode=True)
        want = np.asarray(want)[:q.shape[0]]
    else:
        want, _ = knn_select_xla(jnp.asarray(q), jnp.asarray(r), k, nr=nr)
    want = np.sort(np.asarray(want, np.float64), axis=1)
    idx = idx.numpy()
    diff = q[:, None, :] - r[np.maximum(idx, 0)]
    got = np.where(idx < 0, np.inf, (diff * diff).sum(-1))
    got = np.sort(got, axis=1)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    return float(np.max(np.abs(got[fin] - want[fin])
                        / np.maximum(want[fin], 1e-30)))


def test_legs_match_jax_knn_select_xla(monkeypatch):
    calls = []

    def recorder(fn):
        @functools.wraps(fn)
        def wrapped(query, ref, k, **kw):
            out = fn(query, ref, k, **kw)
            calls.append((query, ref, k, kw, out))
            return out
        return wrapped
    for name in KERNELS:
        monkeypatch.setattr(kh, name, recorder(getattr(kh, name)))
    checks, failures = kernel_cert.run_cert(*SHAPE, "cpu",
                                            emit=lambda rec: None)
    assert not failures
    assert len(calls) == len(checks)
    worst = 0.0
    for query, ref, k, kw, (_, idx) in calls:
        self_mode = kw.get("self_mode", False)
        if query.dim() == 2:
            members = [(query, ref, idx, kw.get("nr") or ref.shape[0])]
        else:
            members = [(query[b, :n], ref[b], idx[b, :n], n)
                       for b, n in enumerate(kw["nr"])]
        for q, r, i, nr in members:
            worst = max(worst, _d2_rel_to_xla(q, r, i, k, self_mode, nr))
    assert worst <= kernel_cert.REL_TOL


def test_a_wrong_index_fails_with_exit_1(monkeypatch):
    real = kh.knn_select_small_k

    def wrong(query, ref, k, **kw):
        d2, idx = real(query, ref, k, **kw)
        idx = idx.clone()
        idx[:, -1] = idx[:, -1].roll(1)      # another row's farthest
        return d2, idx
    monkeypatch.setattr(kh, "knn_select_small_k", wrong)
    rc, lines = run([str(a) for a in SHAPE] + ["--device", "cpu"])
    assert rc == 1
    failed = [ln for ln in lines if ln.startswith("FAIL ")]
    assert failed and all("small_k/" in ln for ln in failed)
    assert lines[-1].startswith(f"FAILED: {len(failed)} of ")


def test_compare_prints_the_kernel_phase_line(capsys):
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(300, 8)),
                        dtype=torch.float32)
    rel, _ = kernel_cert.compare("small_k self", kh.knn_select_small_k, x,
                                 x, 9, True, returned=True)
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == "kernel_vs_plain" and rec["ok"]
    assert rec["leg"] == "small_k self" and rec["max_rel_d2_err"] == rel
    assert rec["returned_d2_tol"] == kernel_cert.D2_REL_TOL


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="cuda"):
        run([])
