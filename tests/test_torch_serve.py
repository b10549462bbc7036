"""The port's JSON-lines service and ``--json`` against ``mcevidence_tpu``'s.

Every request runs through both services' ``handle_request`` on the same
toy root, the port's with ``device="cpu"`` (a process-level option of the
service, not a request field); the ln Z values agree within 1e-9 and the
other fields are equal.  The cases of tests/test_serve.py that concern the
protocol (malformed lines, unknown fields, ordering under ``--workers``,
the bounded shutdown) run against the port's ``serve`` the same way.
"""

import io
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from jax.experimental.pallas import tpu as pltpu
from mcevidence_tpu import serve as jax_serve
from mcevidence_tpu_torch import cli as port_cli
from mcevidence_tpu_torch import evidence_fn, serve
from tests.conftest import make_gaussian_chain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """tests/test_serve.py's root: 2 chains from a normalized Gaussian
    likelihood over the declared prior box (volume 0.2^3)."""
    tmp = tmp_path_factory.mktemp("toy")
    theta, lnl = make_gaussian_chain(np.random.default_rng(12345), n=1200,
                                     ndim=3, sigma=0.02)
    (tmp / "toy.ranges").write_text(
        "omegabh2 0.9 1.1\nomegach2 1.9 2.1\ntheta 2.9 3.1\n")
    for i, sl in enumerate((slice(0, 600), slice(600, None)), 1):
        cols = np.column_stack([np.ones(600), -lnl[sl], theta[sl]])
        np.savetxt(tmp / f"toy_{i}.txt", cols)
    return str(tmp / "toy"), theta, lnl


def _roundtrip(lines, workers=1):
    out = io.StringIO()
    rc = serve.serve(io.StringIO("\n".join(lines) + "\n"), out,
                     workers=workers, device="cpu")
    assert rc == 0
    return [json.loads(s) for s in out.getvalue().splitlines()]


def assert_same_response(got, want, atol=1e-9):
    assert set(got) == set(want)
    for key in want:
        if key == "wall_s":
            assert got[key] > 0
        elif key in ("lnz", "per_chain_mean", "per_chain_err",
                     "bootstrap_lnz", "bootstrap_err"):
            np.testing.assert_allclose(np.asarray(got[key], float),
                                       np.asarray(want[key], float),
                                       rtol=0, atol=atol)
        else:
            assert got[key] == want[key], key


REQUESTS = {
    "refine": ({"kmax": 3}, 1e-9),
    "device": ({"kmax": 3, "precision": "device"}, 1e-9),
    "fast": ({"kmax": 3, "precision": "fast"}, 1e-4),
    "cross_error": ({"kmax": 2, "cross": True, "seed": 7, "error": True},
                    1e-9),
    "burn_thin_bootstrap": ({"kmax": 2, "burn": 0.1, "thin": 0.5, "seed": 2,
                             "bootstrap": 6}, 1e-9),
    "idchain_ndim": ({"kmax": 2, "idchain": 2, "ndim": 2}, 1e-9),
    "pallas_packed_refine": ({"kmax": 3, "engine": "pallas_packed"}, 1e-9),
    "pallas_packed_fast": ({"kmax": 3, "engine": "pallas_packed",
                            "precision": "fast"}, 1e-4),
    "pallas_packed2_device": ({"kmax": 3, "engine": "pallas_packed2",
                               "precision": "device"}, 1e-9),
    "pallas_binned_fast": ({"kmax": 3, "engine": "pallas_binned",
                            "precision": "fast"}, 1e-4),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_handle_request_matches_reference(toy_root, name):
    root, _, _ = toy_root
    fields, atol = REQUESTS[name]
    req = dict(fields, id=name, root=root)
    with pltpu.force_tpu_interpret_mode():
        want = jax_serve.handle_request(
            dict(req, engine=req.get("engine", "xla")))
    got = serve.handle_request(req, device="cpu")
    assert want["ok"] and got["ok"], (want, got)
    assert_same_response(got, want, atol)


def test_serve_evidence_and_errors(toy_root):
    root, theta, lnl = toy_root
    resps = _roundtrip([
        json.dumps({"id": "a", "root": root, "kmax": 2, "seed": 0}),
        "",                                            # blank: ignored
        "{not json",
        json.dumps({"id": "b", "root": root, "bogus_field": 1}),
        json.dumps({"id": "c", "root": root + "_missing"}),
        json.dumps({"id": "d", "kmax": 2}),
        json.dumps({"id": "e", "root": root, "kmax": 2, "cross": True,
                    "seed": 7, "error": True}),
    ])
    assert len(resps) == 6                             # blank line skipped
    a, bad, b, c, d, e = resps
    assert a["id"] == "a" and a["ok"]
    assert abs(a["lnz"][0] - (-math.log(0.2 ** 3))) < 0.3
    assert a["prior_volume"] == pytest.approx(0.2 ** 3)
    assert a["ndim"] == 3 and a["kmax"] == 2 and a["wall_s"] > 0
    direct = evidence_fn(theta, lnl, kmax=2, prior_volume=0.2 ** 3,
                         device="cpu")
    assert a["lnz"][0] == pytest.approx(float(direct[0]), abs=1e-10)
    assert not bad["ok"] and "bad JSON" in bad["error"]
    assert not b["ok"] and "bogus_field" in b["error"]
    assert not c["ok"] and b["id"] == "b" and c["id"] == "c"
    assert not d["ok"] and "root" in d["error"]
    assert e["ok"] and len(e["per_chain_mean"]) == 1
    assert e["per_chain_err"][0] >= 0


def test_serve_bootstrap_and_volume_fallback(tmp_path):
    theta, lnl = make_gaussian_chain(np.random.default_rng(5), n=800,
                                     ndim=2, sigma=0.05)
    np.savetxt(tmp_path / "bare_1.txt",
               np.column_stack([np.ones(800), -lnl, theta]))
    root = str(tmp_path / "bare")                     # no .ranges file
    fail, pv, boot = _roundtrip([
        json.dumps({"root": root, "kmax": 2}),
        json.dumps({"root": root, "kmax": 2, "priorvolume": 2.5}),
        json.dumps({"root": root, "kmax": 2, "unit_volume_fallback": True,
                    "bootstrap": 8, "seed": 1}),
    ])
    assert not fail["ok"]
    assert pv["ok"] and pv["prior_volume"] == 2.5
    assert boot["ok"] and len(boot["bootstrap_lnz"]) == 1
    assert boot["bootstrap_err"][0] > 0
    assert pv["lnz"][0] == pytest.approx(boot["lnz"][0] - math.log(2.5),
                                         abs=1e-9)


def test_serve_leg_failures_keep_evidence(tmp_path):
    theta, lnl = make_gaussian_chain(np.random.default_rng(6), n=400,
                                     ndim=2, sigma=0.05)
    np.savetxt(tmp_path / "one_1.txt",
               np.column_stack([np.ones(400), -lnl, theta]))
    base = {"root": str(tmp_path / "one"), "kmax": 2, "priorvolume": 1.0}
    err, nul, bad = _roundtrip([
        json.dumps(dict(base, error=True)),       # 1 chain: no scatter bar
        json.dumps(dict(base, bootstrap=None)),
        json.dumps(dict(base, bootstrap="many")),
    ])
    for resp in (err, nul, bad):
        assert resp["ok"] and np.isfinite(resp["lnz"]).all()
    assert "error_bars_error" in err and "per_chain_mean" not in err
    assert "bootstrap_error" not in nul
    assert "bootstrap_error" in bad


def test_serve_json_is_rfc_strict():
    assert serve._floats([np.inf, -np.inf, np.nan, 1.5]) == \
        [None, None, None, 1.5]
    assert serve._ALLOWED == jax_serve._ALLOWED


def test_serve_cuda_without_a_card_fails_per_request(toy_root, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _, _ = toy_root
    resp = serve.handle_request({"id": 1, "root": root})
    assert not resp["ok"] and "torch.cuda.is_available() is False" in \
        resp["error"]


@pytest.mark.parametrize("workers", [1, 2])
def test_serve_workers_match_reference_in_order(toy_root, workers):
    """Same responses, in request order, as the JAX service in serial
    mode, for a mixed stream with malformed lines and failing requests."""
    root, _, _ = toy_root
    lines = [json.dumps({"id": i, "root": root, "kmax": 2, "seed": 0,
                         "precision": p})
             for i, p in enumerate(["refine", "device", "refine",
                                    "device"])] + [
        "{not json",
        json.dumps({"id": "x", "root": root + "_missing"}),
        json.dumps({"id": "y", "root": root, "kmax": 2, "cross": True,
                    "seed": 3}),
    ]
    want_out = io.StringIO()
    jax_lines = [ln if not ln.startswith("{\"id\"") else json.dumps(
        dict(json.loads(ln), engine="xla")) for ln in lines]
    assert jax_serve.serve(io.StringIO("\n".join(jax_lines) + "\n"),
                           want_out) == 0
    want = [json.loads(s) for s in want_out.getvalue().splitlines()]
    got = _roundtrip(lines, workers=workers)
    assert [r.get("id") for r in got] == [r.get("id") for r in want]
    for g, w in zip(got, want):
        assert g["ok"] == w["ok"]
        if w["ok"]:
            np.testing.assert_allclose(g["lnz"], w["lnz"], rtol=0,
                                       atol=1e-9)


def test_serve_wedged_shutdown_returns_hard_exit_rc(monkeypatch):
    release = threading.Event()

    def fake_handle(req, device="cuda"):
        if req.get("wedge"):
            release.wait()
            return {"id": req.get("id"), "ok": False, "error": "late"}
        return {"id": req.get("id"), "ok": True}

    monkeypatch.setattr(serve, "handle_request", fake_handle)
    monkeypatch.setenv("MCE_SERVE_SHUTDOWN_STALL_S", "0.3")
    try:
        rc = serve.serve(io.StringIO('{"id": 0, "wedge": true}\n{"id": 1}\n'),
                         io.StringIO(), workers=2)
    finally:
        release.set()
    assert rc == 2


def test_serve_slow_head_of_line_not_dropped(monkeypatch):
    import time

    def fake_handle(req, device="cuda"):
        if req["id"] == 0:
            time.sleep(2.5)          # slower than one stall window
        return {"id": req["id"], "ok": True}

    monkeypatch.setattr(serve, "handle_request", fake_handle)
    monkeypatch.setenv("MCE_SERVE_SHUTDOWN_STALL_S", "2")
    out = io.StringIO()
    assert serve.serve(io.StringIO('{"id": 0}\n{"id": 1}\n'), out,
                       workers=2) == 0
    resp = [json.loads(s) for s in out.getvalue().splitlines()]
    assert [r["id"] for r in resp] == [0, 1] and all(r["ok"] for r in resp)


def test_serve_main_lockstep_client_with_workers(toy_root):
    """The real entry point in a child process on pipes, ``--workers 2
    --device cpu --warmup``: a lock-step client (one request, then wait for
    its response) gets every response, in order."""
    root, _, _ = toy_root
    proc = subprocess.Popen(
        [sys.executable, "-m", "mcevidence_tpu_torch.serve", "--workers",
         "2", "--device", "cpu", "--warmup", "300,3"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        got = []

        def lockstep():
            for i in range(3):
                proc.stdin.write(json.dumps(
                    {"id": i, "root": root, "kmax": 2}) + "\n")
                proc.stdin.flush()
                got.append(json.loads(proc.stdout.readline()))
            proc.stdin.close()

        t = threading.Thread(target=lockstep, daemon=True)
        t.start()
        t.join(timeout=240)
        assert not t.is_alive(), "lock-step client deadlocked"
        assert [r["id"] for r in got] == [0, 1, 2]
        assert all(r["ok"] for r in got)
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()


def test_serve_main_refuses_a_missing_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main([]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


@pytest.mark.parametrize("args", [
    ["-k", "2", "--seed", "0"],
    ["-k", "3", "--precision", "fast", "--engine", "pallas_packed"],
    ["-k", "2", "--cross", "--seed", "1", "--error"],
], ids=["auto", "packed_fast", "cross_error"])
def test_cli_json_matches_reference(toy_root, capsys, args):
    from mcevidence_tpu import cli as jax_cli
    root, _, _ = toy_root
    jax_args = list(args)
    if "--engine" not in jax_args:
        jax_args += ["--engine", "xla"]
    with pltpu.force_tpu_interpret_mode():
        assert jax_cli.main([root, "--json"] + jax_args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_cli.main([root, "--json", "--device", "cpu"] + args) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert_same_response(got, want,
                         1e-4 if "fast" in args else 1e-9)


def test_cli_json_failure_is_one_line_and_exit_2(tmp_path, capsys):
    assert port_cli.main([str(tmp_path / "absent"), "--json", "--device",
                          "cpu"]) == 2
    resp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not resp["ok"] and "error" in resp
