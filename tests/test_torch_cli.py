"""The port's CLI against the JAX CLI on one CosmoMC root."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcevidence_tpu import cli as jax_cli
from mcevidence_tpu_torch import cli as port_cli

LNB = re.compile(r"^\s*(.*ln\(B\)\[k=\d+\]) = (\S+)(?: \+/- (\S+))?$")


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """toy_1.txt, toy_2.txt (weight, -lnL, params) and toy.ranges, drawn
    exactly from the normalised likelihood."""
    tmp = tmp_path_factory.mktemp("toy")
    rng = np.random.default_rng(21)
    mean = np.array([0.0224, 0.12, 0.055])
    sig = np.array([0.0002, 0.002, 0.01])
    (tmp / "toy.ranges").write_text("".join(
        f"{name} {m - 10 * s} {m + 10 * s}\n"
        for name, m, s in zip(["omegabh2", "omegach2", "tau"], mean, sig)))
    for c in (1, 2):
        th = rng.normal(mean, sig, size=(600, 3))
        neglnl = (0.5 * np.sum(((th - mean) / sig) ** 2, axis=1)
                  + 1.5 * np.log(2 * np.pi) + np.sum(np.log(sig)))
        np.savetxt(tmp / f"toy_{c}.txt",
                   np.column_stack(
                       [rng.integers(1, 3, 600).astype(float), neglnl, th]))
    return str(tmp / "toy")


def _lnb_lines(text):
    out = {}
    for line in text.splitlines():
        m = LNB.match(line)
        if m:
            out[m.group(1)] = [float(v) for v in m.groups()[1:] if v]
    return out


@pytest.mark.parametrize("args", [
    ["-k", "3"],
    ["-k", "4", "--cross", "--seed", "1"],
    ["-k", "3", "--burn", "0.2", "--thin", "0.5", "--seed", "2", "--error"],
    ["-k", "3", "--bootstrap", "8", "--seed", "3"],
], ids=["auto", "cross", "burn_thin_error", "bootstrap"])
def test_cli_matches_reference(toy_root, capsys, args):
    assert jax_cli.main([toy_root, "-vb", "0", "--engine", "xla"] + args) == 0
    want = _lnb_lines(capsys.readouterr().out)
    assert port_cli.main([toy_root, "-vb", "0", "--device", "cpu"]
                         + args) == 0
    got = _lnb_lines(capsys.readouterr().out)
    assert want and got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9)


@pytest.mark.parametrize("args", [
    ["-k", "3", "--precision", "device"],
    ["-k", "4", "--cross", "--seed", "1", "--precision", "device"],
], ids=["auto", "cross"])
def test_cli_device_precision_matches_reference(toy_root, capsys, args):
    assert jax_cli.main([toy_root, "-vb", "0", "--engine", "xla"] + args) == 0
    want = _lnb_lines(capsys.readouterr().out)
    assert port_cli.main([toy_root, "-vb", "0", "--device", "cpu"]
                         + args) == 0
    got = _lnb_lines(capsys.readouterr().out)
    assert want and got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9)


@pytest.mark.parametrize("args,message", [
    (["--json"], "ROADMAP.md Queue 1, item 8"),
], ids=["json"])
def test_cli_unported_options_exit_2(toy_root, capsys, args, message):
    assert port_cli.main([toy_root, "--device", "cpu"] + args) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("args,atol", [
    (["-k", "3", "--precision", "fast"], 1e-4),
    (["-k", "3", "--engine", "pallas_exact"], 1e-9),
    (["-k", "4", "--cross", "--seed", "1", "--engine", "pallas_smalld"],
     1e-9),
    (["-k", "3", "--engine", "pallas_smalld", "--precision", "device"],
     1e-9),
], ids=["fast", "pallas_exact", "pallas_smalld", "pallas_smalld_device"])
def test_cli_fast_and_forced_engines_match_reference(toy_root, capsys, args,
                                                     atol):
    """The port's forced engines against the JAX CLI on its plain XLA
    selection (a Pallas engine needs a TPU); ``fast`` is f32 on both sides,
    the others refine in f64."""
    engine = args.index("--engine") if "--engine" in args else None
    jax_args = (args if engine is None
                else args[:engine] + ["--engine", "xla"] + args[engine + 2:])
    if engine is None:
        jax_args = jax_args + ["--engine", "xla"]
    assert jax_cli.main([toy_root, "-vb", "0"] + jax_args) == 0
    want = _lnb_lines(capsys.readouterr().out)
    assert port_cli.main([toy_root, "-vb", "0", "--device", "cpu"]
                         + args) == 0
    got = _lnb_lines(capsys.readouterr().out)
    assert want and got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol)


def test_cli_cuda_without_a_card_exits_2(toy_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_cli.main([toy_root]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_port_imports_no_jax():
    code = ("import sys, mcevidence_tpu_torch\n"
            "from mcevidence_tpu_torch import cli\n"
            "try:\n"
            "    cli.main(['--help'])\n"
            "except SystemExit:\n"
            "    pass\n"
            "import mcevidence_tpu_torch.interop, mcevidence_tpu_torch.ops\n"
            "mcevidence_tpu_torch.evidence_fn\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED False" in proc.stdout
