"""The port's model comparison against ``mcevidence_tpu.compare``.

The same roots go through both ``compare_models`` (the port's on
``device="cpu"``, the JAX package's on its plain XLA selection); the rows
must carry the same keys, the same metadata and ln E within 1e-9.  The
cases mirror tests/test_compare.py.
"""

import json

import numpy as np
import pytest

from mcevidence_tpu import compare as jax_compare
from mcevidence_tpu_torch import compare
from tests.test_compare import _make_root

NUMERIC = ("lnE", "delta_lnE", "mean_lnE", "err_lnE")


def assert_same_rows(got, want, atol=1e-9):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key in NUMERIC:
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=atol)
            elif key == "PriorVol":
                assert g[key] == pytest.approx(w[key], rel=1e-12,
                                               nan_ok=True)
            else:
                assert g[key] == w[key], key


@pytest.fixture
def roots(tmp_path, rng):
    return {"A": _make_root(tmp_path, "ma", [0.0, 1.0], [0.05, 0.05],
                            rng=rng),
            "B": _make_root(tmp_path, "mb", [0.0, 1.0, 2.0],
                            [0.05, 0.05, 0.05], rng=rng)}


@pytest.mark.parametrize("kw", [
    dict(kmax=2, seed=0),
    dict(kmax=4, precision="device"),
    dict(kmax=3, precision="fast"),
    dict(kmax=2, split=True, seed=3),
    dict(kmax=2, base="B", normalize=True, burnlen=0.2),
    dict(kmax=2, allparams=True, thinlen=0.5, seed=4),
], ids=["defaults", "device", "fast", "cross", "base_burn", "allparams"])
def test_compare_models_matches_reference(roots, kw):
    want = jax_compare.compare_models(roots, engine="xla", **kw)
    got = compare.compare_models(roots, device="cpu", **kw)
    assert_same_rows(got, want, 1e-4 if kw.get("precision") == "fast"
                     else 1e-9)
    best = max(got, key=lambda r: r["lnE"][0])
    assert best["delta_lnE"][0] == 0.0


def test_compare_models_nan_degradation_matches_reference(tmp_path, rng):
    ok = _make_root(tmp_path, "ok", [0.5], [0.1], rng=rng)
    d = tmp_path / "broken"
    d.mkdir()
    (d / "broken.ranges").write_text("omegabh2 0 1\n")
    roots = {"ok": ok, "broken": str(d / "broken")}
    want = jax_compare.compare_models(roots, kmax=2, engine="xla")
    got = compare.compare_models(roots, kmax=2, device="cpu")
    assert np.all(np.isnan(got[1]["lnE"])) and "error" in got[1]
    got[1].pop("error"), want[1].pop("error")   # exception texts may differ
    assert_same_rows(got, want)


def test_compare_models_error_bars_match_reference(tmp_path, rng):
    roots = [_make_root(tmp_path, "x1", [0.0], [0.1], rng=rng, nchain=3),
             _make_root(tmp_path, "x2", [0.0], [0.1], rng=rng, nchain=3)]
    want = jax_compare.compare_models(roots, kmax=2, error=True, base="x2",
                                      engine="xla", seed=1)
    got = compare.compare_models(roots, kmax=2, error=True, base="x2",
                                 seed=1, device="cpu")
    assert all(r["err_lnE"][0] > 0 for r in got)
    assert_same_rows(got, want)


@pytest.mark.parametrize("args", [
    ["-k", "2", "--json"],
    ["-k", "3", "--json", "-ic", "1", "--engine", "pallas_packed"],
    ["-k", "5"],
], ids=["json", "json_idchain_packed", "table"])
def test_compare_cli_matches_reference(roots, capsys, args):
    argv = [f"{name}={root}" for name, root in roots.items()] + args
    jax_args = [a if a != "pallas_packed" else "xla" for a in argv]
    if "--engine" not in jax_args:
        jax_args += ["--engine", "xla"]
    assert jax_compare.main(jax_args) == 0
    want = capsys.readouterr().out
    assert compare.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    if "--json" not in args:
        assert got == want          # the table prints ln E to 0.01
        return
    want = json.loads(want.strip().splitlines()[-1])
    got = json.loads(got.strip().splitlines()[-1])
    assert_same_rows(got, want)


def test_compare_cli_refuses_a_missing_card(roots, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compare.main([roots["A"]]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
