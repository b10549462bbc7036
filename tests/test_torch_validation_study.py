"""The port's validation study against ``scripts/validation_study.py``.

Three checks, all on the CPU:

* every array a leg hands the estimator is ``np.array_equal`` to what JAX's
  script hands its estimator for the same seed (both estimators replaced by
  recorders, at the published sizes);
* each leg's per-seed ln Z, at reduced sizes, is within 1e-9 of JAX's
  ``evidence_fn`` on the same arrays (the nested leg's: of JAX's
  ``MCEvidence(engine="xla")``, as the script runs it);
* the N sweep at N = 2000 and 8000 (d=4, 10 seeds) prints
  docs/VALIDATION_STUDY.md's rows, as ``chip_smoke.py``'s reader of the
  document gives them.

JAX's script and ``chip_smoke.py`` are loaded from their files; the port's
module imports no JAX.
"""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest

import mcevidence_tpu.evidence as jev
from mcevidence_tpu import evidence_fn as jax_evidence_fn
from mcevidence_tpu_torch import validation_study as pvs

ATOL_JAX = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jvs():
    return load("jax_validation_study", "scripts", "validation_study.py")


@pytest.fixture(scope="module")
def smoke():
    return load("chip_smoke_for_study", "chip_smoke.py")


def stand_in(samples, kw):
    """A cheap answer that depends on the chain: a column's mean and the
    row count, one value a k."""
    k = np.arange(1, max(2, kw.get("kmax", 5)))
    return np.mean(samples[:, 0]) + 1e-6 * len(samples) * k


class Recorder:
    """Stands in for ``evidence_fn`` and ``MCEvidence``: keeps every call's
    arrays and options, and answers with ``stand_in`` (``through`` set:
    with the real estimator's answer), kept beside the call."""

    def __init__(self, through=None):
        self.calls, self.through = [], through

    def evidence_fn(self, *args, **kw):
        out = (self.through(*args, **kw) if self.through
               else stand_in(args[0], kw))
        self.calls.append(("evidence_fn", args, kw, out))
        return out

    def mcevidence(self, chains, **kw):
        rec = self

        class Estimate:
            def evidence(self):
                out = (rec.through(chains, **kw).evidence() if rec.through
                       else stand_in(chains[0][:, 2:], kw))
                rec.calls.append(("MCEvidence", tuple(chains), kw, out))
                return out
        return Estimate()


def options(kw):
    """The options both packages share (the port adds ``device``, JAX's
    nested leg ``engine``)."""
    return {k: v for k, v in kw.items() if k not in ("device", "engine")}


def assert_same_calls(got, want):
    assert len(got) == len(want)
    for (gname, gargs, gkw, _), (wname, wargs, wkw, _) in zip(got, want):
        assert gname == wname
        assert len(gargs) == len(wargs)
        for a, b in zip(gargs, wargs):
            assert np.array_equal(a, b)
        gopt, wopt = options(gkw), options(wkw)
        assert gopt.keys() == wopt.keys()
        for k in gopt:
            assert np.array_equal(gopt[k], wopt[k]), k


def quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_every_leg_draws_jax_arrays(jvs, monkeypatch):
    """All tables at one seed (cross at the script's floor of 24; nested,
    whose floor is 8, at 2), the estimators replaced by ``stand_in``: the
    same calls with the same arrays, and the same markdown."""
    want, got = Recorder(), Recorder()
    for module in (jvs, pvs):
        nested = module.nested_leg
        monkeypatch.setattr(module, "nested_leg",
                            lambda n_seeds, *a, leg=nested: leg(2, *a))
    monkeypatch.setattr(jvs, "evidence_fn", want.evidence_fn)
    monkeypatch.setattr(jev, "MCEvidence", want.mcevidence)
    _, jax_text = quiet(jvs.main, 1)
    monkeypatch.setattr(pvs, "evidence_fn", got.evidence_fn)
    monkeypatch.setattr(pvs, "MCEvidence", got.mcevidence)
    _, port_text = quiet(pvs.study, 1, "cpu")
    assert_same_calls(got.calls, want.calls)
    assert port_text == jax_text


def port_leg_against_jax(monkeypatch, leg, *args, **kw):
    """Run the port's ``leg`` on the CPU, every ``evidence_fn`` call passed
    through and kept; hold each call's answer to JAX's on the same arrays,
    and return the rows and the answers."""
    rec = Recorder(through=pvs.evidence_fn)
    monkeypatch.setattr(pvs, "evidence_fn", rec.evidence_fn)
    rows, _ = quiet(leg, *args, **kw)
    assert rec.calls
    for _, a, k, out in rec.calls:
        np.testing.assert_allclose(out, jax_evidence_fn(*a, **options(k)),
                                   rtol=0, atol=ATOL_JAX)
    return rows, [c[3] for c in rec.calls]


@pytest.mark.parametrize("leg,args,kw,take", [
    (pvs.convergence_table, (2, "cpu"), {"sizes": (2000,)},
     lambda out: [o[0] for o in out]),
    (pvs.dimension_table, (1, "cpu"), {"n": 2000},
     lambda out: [[o[0], o[3]] for o in out]),
    (pvs.correlated_table, (1, "cpu"), {"n": 2000},
     lambda out: [o[0] for o in out]),
    (pvs.importance_leg, (1, "cpu"), {"n": 2000},
     lambda out: [o[0] for o in out]),
    (pvs.banana_leg, (1, "cpu"), {"sizes": (2000,)},
     lambda out: [o[0] for o in out]),
    (pvs.autocorr_leg, (1, "cpu"), {"nsteps": 260},
     lambda out: [o[0] for o in out]),
], ids=["convergence", "dimension", "correlated", "importance", "banana",
        "autocorr"])
def test_leg_lnz_matches_jax(monkeypatch, leg, args, kw, take):
    rows, outs = port_leg_against_jax(monkeypatch, leg, *args, **kw)
    per_seed = take(outs)
    if leg is pvs.autocorr_leg:       # one chain, two thinnings a seed
        assert [r["lnz"][0] for r in rows] == per_seed
    else:
        assert [x for r in rows for x in r["lnz"]] == per_seed
    for r in rows:
        assert all(np.isfinite(np.ravel(r["lnz"])))


def test_cross_leg_lnz_matches_jax(monkeypatch):
    rows, outs = port_leg_against_jax(monkeypatch, pvs.cross_leg, 2, "cpu",
                                      n=2000)
    split, matched = rows["cross_split"], rows["cross_matched"]
    # per d: (auto, cross) a seed for the split table, then the matched's
    # (auto k=1..2, cross) a seed
    assert [len(r["lnz"]["auto"]) for r in split + matched] == [2] * 4
    assert split[0]["lnz"]["auto"] == [outs[0][0], outs[2][0]]
    assert split[0]["lnz"]["cross"] == [outs[1][0], outs[3][0]]
    assert matched[0]["lnz"]["auto"][0] == list(outs[8][:2])
    for r in split:
        a, c = np.asarray(r["lnz"]["auto"]), np.asarray(r["lnz"]["cross"])
        assert r["ratio"] == pytest.approx(a.std(ddof=1) / c.std(ddof=1))


def test_nested_leg_matches_jax_xla(jvs, monkeypatch):
    """The port's nested leg (default engine, the plain selection on the
    CPU) against JAX's script, whose leg runs ``engine="xla"``."""
    rec = Recorder(through=jev.MCEvidence)
    monkeypatch.setattr(jev, "MCEvidence", rec.mcevidence)
    quiet(jvs.nested_leg, 1)
    assert all(c[2]["engine"] == "xla" for c in rec.calls)
    want = [c[3][0] for c in rec.calls]
    rows, _ = quiet(pvs.nested_leg, 1, "cpu")
    got = {(r["d"], r["input"]): r["lnz"][0] for r in rows}
    for i, d in enumerate((2, 4, 8)):
        for j, name in enumerate(("equal-weights", "weighted dead-point")):
            assert got[(d, name)] == pytest.approx(want[2 * i + j], rel=0,
                                                   abs=ATOL_JAX)
        truth = -d * np.log(2.0)
        assert abs(got[(d, "equal-weights")] - truth) < 0.35


def test_convergence_rows_print_the_document(smoke):
    """docs/VALIDATION_STUDY.md's first two N-sweep rows, from the same ten
    seeds a cell, on the CPU."""
    doc = smoke.study_document()
    rows, text = quiet(pvs.convergence_table, 10, "cpu",
                       sizes=(2000, 8000))
    for r in rows:
        assert r["cells"][1:] == doc["convergence"][r["N"]]
        assert "| " + " | ".join(r["cells"]) + " |" in text
    assert "| 2000 | -0.0312 | 0.0379 |" in text
    assert "| 8000 | -0.0201 | 0.0255 |" in text


def test_document_cells_are_held_digit_for_digit(smoke):
    """Every table of the document read back (75 printed cells), and
    ``held_study_cells`` holds rows shaped like the study module's to them:
    the document's own digits pass, one moved digit or a row the document
    lacks is a mismatch."""
    doc = smoke.study_document()
    assert sum(len(c) for t in doc.values() for c in t.values()) == 75
    assert doc["nested"][(4, "weighted dead-point")] == ("-0.0158", "0.0436")
    assert doc["cross_matched"][(32000, 4)][3] == "1.39"
    for name, fields, first in smoke.STUDY_TABLES:
        rows = []
        for key, want in doc[name].items():
            key = key if isinstance(key, tuple) else (key,)
            cells = (*map(str, key), *["?"] * (first - len(key)), *want)
            rows.append({**dict(zip(fields, key)), "cells": cells})
        assert smoke.held_study_cells(doc, name, rows) == (
            sum(map(len, doc[name].values())), [])
        moved = [{**rows[0], "cells": (*rows[0]["cells"][:-1], "0.9999")},
                 *rows[1:]]
        assert len(smoke.held_study_cells(doc, name, moved)[1]) == 1
        extra = {**rows[0], fields[0]: 3}
        assert len(smoke.held_study_cells(doc, name, [*rows, extra])[1]) == 2


def test_cell_is_jax_cell_on_the_same_seeds(jvs):
    v = pvs.cell_lnz(2000, 4, 2, 2, (0,), "cpu")
    want = jvs.cell(2000, 4, 2, 2, (0,))
    got = [(float(v[:, 0].mean()), float(np.sqrt(np.mean(v[:, 0] ** 2))))]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)


def test_cli_needs_a_card_unless_told_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pvs.main(["1", "importance"])
    with pytest.raises(SystemExit):
        quiet(pvs.main, ["1", "bogus", "--device", "cpu"])
