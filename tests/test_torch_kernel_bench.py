"""The port's kernel timings (``mcevidence_tpu_torch.kernel_bench``) on the
CPU.

The bound is pinned to the values ``PERF.md`` prints for the kernels' main
shapes (to the printed 3 decimals), the rows' JSON schema is checked with a
stubbed timer, the library pair is held to the plain selection, and the
four new modules must import without JAX.
"""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcevidence_tpu_torch import kernel_bench as kb
from mcevidence_tpu_torch.ops import knn_hopper as kh

ROW_FIELDS = {"phase", "kernel", "shape", "ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "share_of_bound", "pairs_per_s", "gpu"}
STUB_MS = 2.0


@pytest.mark.parametrize("kernel,n,d,k,batch,ms", [
    ("knn_select_small_k", 65536, 8, 9, 1, 1.026),
    ("knn_select_large_k", 64000, 3, 32, 1, 0.367),
    ("knn_select_smalld", 65536, 8, 9, 1, 1.538),
    ("knn_select_batched", 16384, 8, 6, 4, 0.256),
    ("knn_select_small_k", 2 ** 20, 8, 9, 1, 262.570),
])
def test_bound_pins_perf_values(kernel, n, d, k, batch, ms):
    b_ms, b_by = kb.bound(kernel, n, d, k, batch)
    assert round(b_ms, 3) == ms
    assert b_by == "operations"


def test_bound_reads_bytes_when_they_bind():
    # one row of width 1 and many neighbours: the output bytes bind
    b_ms, b_by = kb.bound("knn_select_wide", 2, 1, 4096)
    assert b_by == "bytes"
    assert b_ms == (4.0 * 2 + 8.0 * 2 * 4096) / kb.HBM_RATE * 1e3


def stub_timer(fn, reps=5):
    fn()
    return STUB_MS


def run(argv, monkeypatch):
    monkeypatch.setattr(kb, "host_ms", stub_timer)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = kb.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()]


def check_row(row):
    assert set(row) - {"plain_pairs_per_s"} == ROW_FIELDS
    assert row["phase"] == "time" and row["ms"] == STUB_MS
    assert row["share_of_bound"] == row["bound_ms"] / STUB_MS
    assert row["gpu"] is None          # on the CPU: no card to name


def test_kernel_rows_schema(monkeypatch):
    rc, rows = run(["--kernel", "knn_select_small_k", "--n", "256", "--d",
                    "8", "--k", "5", "9", "--device", "cpu"], monkeypatch)
    assert rc == 0 and len(rows) == 2
    for row, k in zip(rows, (5, 9)):
        check_row(row)
        assert row["shape"] == f"self N=256 d=8 k={k}"
        assert row["plain_ms"] == row["library_ms"] == STUB_MS
        assert row["plain_pairs_per_s"] == 256.0 ** 2 / (STUB_MS * 1e-3)
        assert row["bound_ms"] == kb.bound("knn_select_small_k", 256, 8,
                                           k)[0]


def test_an_untimed_plain_version_is_null(monkeypatch):
    rc, rows = run(["--kernel", "knn_select_batched", "--n", "128",
                    "--batch", "3", "--k", "6", "--no-plain", "--device",
                    "cpu"], monkeypatch)
    assert rc == 0
    (row,) = rows
    check_row(row)
    assert row["plain_ms"] is None and row["library_ms"] == STUB_MS
    assert "plain_pairs_per_s" not in row
    assert row["shape"] == "self B=3 N=128 d=8 k=6"
    assert row["bound_ms"] == kb.bound("knn_select_batched", 128, 8, 6,
                                       3)[0]


@pytest.mark.parametrize("study,kernels", [
    ("packed2", ["knn_select_packed", "knn_select_small_k"] * 3),
    ("packed2_batched", ["knn_select_packed", "knn_select_batched"]),
    ("smalld", ["knn_select_smalld", "knn_select_small_k"] * 3),
    ("prologue", ["knn_select_small_k", "knn_select_packed",
                  "knn_select_prologue", "knn_select_prologue"] * 2),
])
def test_study_rows(monkeypatch, study, kernels):
    rc, rows = run(["--study", study, "--n", "256", "--device", "cpu"],
                   monkeypatch)
    assert rc == 0
    if study == "prologue":
        gates = [r for r in rows if r["phase"] == "prologue_gate"]
        assert [g["variant"] for g in gates] == ["B", "BC"]
        assert all(g["identical_to_k1"] for g in gates)
        rows = [r for r in rows if r["phase"] == "time"]
    assert [r["kernel"] for r in rows] == kernels
    for row in rows:
        check_row(row)
        assert row["plain_ms"] == row["library_ms"] == STUB_MS


def test_library_pair_is_the_same_selection(monkeypatch):
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 300, 5)),
                        dtype=torch.float32)
    # chunks of 17 query rows
    monkeypatch.setattr(kb, "LIBRARY_PAIR_BYTES", 17 * 3 * 300 * 4)
    chunks = kb.library_pair(x, 7)
    assert len(chunks) == -(-300 // 17)
    dist = torch.cat([c[0] for c in chunks], dim=-2)
    want, _ = kh.knn_select_torch_batched(x, x, 7, self_mode=True)
    torch.testing.assert_close(dist.double() ** 2, want.double(), rtol=1e-5,
                               atol=1e-5)
    flat = kb.library_pair(x[0], 7)
    torch.testing.assert_close(torch.cat([c[0] for c in flat]),
                               dist[0])


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "import mcevidence_tpu_torch.envelope\n"
            "import mcevidence_tpu_torch.kernel_cert\n"
            "import mcevidence_tpu_torch.kernel_bench\n"
            "import mcevidence_tpu_torch.recert\n"
            "print('JAX', 'jax' in sys.modules,\n"
            "      any(m.split('.')[0] == 'mcevidence_tpu'\n"
            "          for m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX False False" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_defaults_to_the_card_and_raises_without_one(monkeypatch):
    with pytest.raises(RuntimeError, match="cuda"):
        run(["--study", "smalld"], monkeypatch)
