"""The port's N envelope (``mcevidence_tpu_torch.envelope``) against the
JAX package's pipeline.

``envelope.main`` runs on the CPU at 2^9..2^11 rows (``--min-pow 9``, the
plain selection), and each point's fast and device ln Z are held to JAX's
``fast_auto_evidence`` and ``device_refine_auto_evidence`` (``engine=
"xla"``) on the same chain, at the tolerances the port's fast and device
tests use for those functions: ``ATOL_FAST`` = 1e-4
(tests/test_torch_fast.py's ``ATOL_JAX``: f32 on both sides, sums in other
orders) and ``ATOL_DEVICE`` = 1e-9 (tests/test_torch_pipeline.py's
``ATOL_REF``).  The chain is JAX's ``scripts/bench_envelope.py``'s, array
for array.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from mcevidence_tpu.ops import pipeline as jax_pipeline
from mcevidence_tpu_torch import envelope
from mcevidence_tpu_torch.ops import pipeline

ATOL_FAST = 1e-4
ATOL_DEVICE = 1e-9
ARGS = ["11", "8", "--min-pow", "9", "--device", "cpu"]
POINTS = (512, 1024, 2048)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"n", "d", "kmax", "plan_gib", "budget_gib", "fast_s", "lnz_fast",
          "fast_pairs_per_s", "device_s", "lnz_device", "dlnz_fast_dev",
          "launches", "gpu"}


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = envelope.main(argv)
    lines = out.getvalue().splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    return rc, lines, recs


@pytest.fixture(scope="module")
def cpu_run():
    return run(ARGS)


def test_one_line_a_point_with_the_schema(cpu_run):
    rc, lines, recs = cpu_run
    assert rc == 0
    assert lines[1].split() == ["N", "plan", "GiB", "fast", "s", "fast",
                                "pairs/s", "device", "s", "dlnz",
                                "fast-dev"]
    assert [r["n"] for r in recs] == list(POINTS)
    for rec in recs:
        assert set(rec) == FIELDS
        assert rec["d"] == 8 and rec["kmax"] == envelope.KMAX == 5
        assert rec["plan_gib"] == pipeline.estimate_device_refine_bytes(
            rec["n"], rec["n"], 8, 9) / 2 ** 30
        assert rec["budget_gib"] is None and rec["gpu"] is None
        assert rec["fast_s"] > 0 and rec["device_s"] > 0
        assert rec["fast_pairs_per_s"] == rec["n"] ** 2 / rec["fast_s"]
        assert len(rec["lnz_fast"]) == len(rec["lnz_device"]) == 4
        assert rec["dlnz_fast_dev"] == np.max(np.abs(
            np.subtract(rec["lnz_fast"], rec["lnz_device"])))
        # the CPU runs the plain selection: no kernel launched
        assert set(rec["launches"].values()) == {0}
        assert "plain_on_cuda" in rec["launches"]


@pytest.mark.parametrize("n", POINTS)
def test_points_match_the_jax_pipeline(cpu_run, n):
    rec = next(r for r in cpu_run[2] if r["n"] == n)
    theta, lnl = envelope.chain(n, 8)
    fast = jax_pipeline.fast_auto_evidence(theta, lnl, kmax=5, engine="xla")
    dev = jax_pipeline.device_refine_auto_evidence(theta, lnl, kmax=5,
                                                   engine="xla")
    np.testing.assert_allclose(rec["lnz_fast"], np.asarray(fast), rtol=0,
                               atol=ATOL_FAST)
    np.testing.assert_allclose(rec["lnz_device"], np.asarray(dev), rtol=0,
                               atol=ATOL_DEVICE)


def test_chain_and_timing_are_the_jax_scripts():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_envelope", os.path.join(ROOT, "scripts",
                                           "bench_envelope.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    for n, d in ((512, 8), (1000, 3)):
        for a, b in zip(envelope.chain(n, d), jax_script.chain(n, d)):
            np.testing.assert_array_equal(a, b)
    calls = []
    sec, out = envelope.timed(lambda x: calls.append(x) or len(calls), 7)
    assert calls == [7, 7] and out == 2 and sec >= 0


@pytest.mark.parametrize("path", ["fast", "device"])
def test_a_point_that_raises_exits_1(monkeypatch, path):
    name = {"fast": "fast_auto_evidence",
            "device": "device_refine_auto_evidence"}[path]
    real = getattr(pipeline, name)

    def flaky(samples, *a, **kw):
        if samples.shape[0] == 1024:
            raise RuntimeError("out of memory")
        return real(samples, *a, **kw)
    monkeypatch.setattr(pipeline, name, flaky)
    rc, lines, recs = run(ARGS)
    assert rc == 1
    bad = next(r for r in recs if r["n"] == 1024)
    assert bad["failed"] == path and "out of memory" in bad["error"]
    assert any(f"{path} FAILED" in ln for ln in lines)
    # a failed fast estimate ends the run; a failed device one does not
    want = [512, 1024] if path == "fast" else list(POINTS)
    assert [r["n"] for r in recs] == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="cuda"):
        run(["9", "8", "--min-pow", "9"])
