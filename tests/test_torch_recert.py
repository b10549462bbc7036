"""The port's recertification runner (``mcevidence_tpu_torch.recert``).

The legs' child processes are replaced by canned results, so these tests
check what the runner does with them: a leg that exits nonzero fails the
run (exit 1) and is recorded, whatever its output says; the artifact goes
to ``--out``, by default under the checkout's git-ignored ``build/``.  The
cert leg's parser reads ``kernel_cert``'s real output.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from mcevidence_tpu_torch import kernel_cert, recert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CERT_OUT = ("device=cuda n=4096 d=12 k=5\n"
            "PASS small_k/self nr=3959        max_rel_d2_err=3.2e-07 "
            "returned_d2_rel_err=0.000e+00\n"
            "PASS large_k/self nr=3959 @k26   max_rel_d2_err=2.7e-07 "
            "returned_d2_rel_err=0.000e+00\n"
            "ALL PASS: 2 checks on cuda\n")
GOOD = {"mcevidence_tpu_torch.kernel_cert": (0, CERT_OUT, ""),
        "mcevidence_tpu_torch.bench": (0, 'table\n{"value": 8.5e11}\n', ""),
        "mcevidence_tpu_torch.bench_serve": (0, '{"metric": "p50"}\n', "")}


def fake_legs(monkeypatch, results):
    seen = []

    def run_leg(args, timeout):
        seen.append(args)
        return results[args[0]]
    monkeypatch.setattr(recert, "run_leg", run_leg)
    return seen


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = recert.main(argv)
    return rc, out.getvalue()


def test_every_leg_passing_writes_an_ok_artifact(monkeypatch, tmp_path):
    seen = fake_legs(monkeypatch, GOOD)
    path = tmp_path / "cert.json"
    rc, out = run(["--device", "cpu", "--out", str(path)])
    assert rc == 0 and out.endswith(f"PASS -> {path}\n")
    art = json.loads(path.read_text())
    assert art["ok"] is True and art["device"] == "cpu"
    assert set(art["legs"]) == {"kernel_cert", "bench", "serve"}
    cert = art["legs"]["kernel_cert"]
    assert (cert["n_pass"], cert["n_total"]) == (2, 2)
    assert cert["worst_rel_d2_err"] == 3.2e-07
    assert art["legs"]["bench"]["parsed"] == {"value": 8.5e11}
    assert seen[-1] == ["mcevidence_tpu_torch.bench_serve",
                        str(recert.SERVE_REPS), "--clients", "1,2,4",
                        "--device", "cpu"]


@pytest.mark.parametrize("leg,key", [
    ("mcevidence_tpu_torch.kernel_cert", "kernel_cert"),
    ("mcevidence_tpu_torch.bench", "bench"),
    ("mcevidence_tpu_torch.bench_serve", "serve")])
def test_a_failing_leg_exits_1_and_is_recorded(monkeypatch, tmp_path, leg,
                                               key):
    # the leg's output still parses: only its exit code says it failed
    results = dict(GOOD)
    results[leg] = (3, GOOD[leg][1], "Traceback: boom")
    fake_legs(monkeypatch, results)
    path = tmp_path / "cert.json"
    rc, out = run(["--device", "cpu", "--out", str(path)])
    assert rc == 1 and out.endswith(f"FAIL -> {path}\n")
    art = json.loads(path.read_text())
    assert art["ok"] is False
    assert art["legs"][key]["rc"] == 3 and art["legs"][key]["ok"] is False
    assert "boom" in art["legs"][key]["stderr_tail"]
    assert all(art["legs"][k]["ok"] for k in art["legs"] if k != key)


def test_skipped_legs_are_left_out(monkeypatch, tmp_path):
    seen = fake_legs(monkeypatch, GOOD)
    path = tmp_path / "cert.json"
    rc, _ = run(["--device", "cpu", "--skip-bench", "--skip-serve", "--out",
                 str(path)])
    assert rc == 0 and [a[0] for a in seen] == [
        "mcevidence_tpu_torch.kernel_cert"]
    assert list(json.loads(path.read_text())["legs"]) == ["kernel_cert"]


def test_default_out_lies_under_build():
    out = recert.default_out()
    assert os.path.dirname(out) == os.path.join(ROOT, "build")
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert "build/" in fh.read().split()


def test_cert_parser_reads_kernel_certs_output(monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = kernel_cert.main(["300", "8", "5", "--device", "cpu"])
    checks = recert.parse_cert(out.getvalue())
    assert rc == 0 and checks
    assert len(checks) == len(kernel_cert.cert_legs(300, 8, 5, "cpu"))
    assert all(c["pass"] for c in checks)
    assert checks[0]["name"] == "small_k/self nr=163"
    bad = recert.parse_cert("FAIL wide/self nr=163 absent slots differ\n")
    assert bad == [{"name": "wide/self nr=163 absent slots differ",
                    "pass": False, "max_rel_d2_err": None}]


def test_a_leg_past_its_time_limit_reads_124():
    rc, _, err = recert.run_leg(["timeit", "-n", "1", "-r", "1",
                                 "import time; time.sleep(60)"], timeout=2)
    assert rc == 124 and err == "timeout after 2 s"
    rc, _, err = recert.run_leg(["mcevidence_tpu_torch.no_such_module"],
                                timeout=60)
    assert rc == 1 and "no_such_module" in err


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_defaults_to_the_card_and_raises_without_one(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        run(["--out", str(tmp_path / "cert.json")])
