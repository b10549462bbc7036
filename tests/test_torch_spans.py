"""The spans inside the port's estimate path
(``mcevidence_tpu_torch/utils/spans.py``), on the CPU.

One refine and one device estimate give the documented ``timings`` keys,
every span lies inside its parent and the steps fit in the span they split;
the 8x8x8 lattice's ties make the guard reselect at kmax=2, a Gaussian
chain does not.  ln Z is bit-identical with no collector, with one and
under a ``torch.profiler`` profile; under a profile the Chrome trace holds
one ``mce.<name>`` annotation per span, nested the same way, and with no
profile no ``record_function`` is entered.  The benchmark's readers of the
spans report on a tiny traced cell and stay silent on readings without
spans.
"""

import importlib.util
import itertools
import json
import os
import sys
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from mcevidence_tpu_torch import MCEvidence
from mcevidence_tpu_torch.bench import synthetic_chain
from mcevidence_tpu_torch.ops.knn import exact_knn
from mcevidence_tpu_torch.ops.pipeline import device_refine_evidence
from mcevidence_tpu_torch.ops.whiten import apply_whiten, whiten_stats
from mcevidence_tpu_torch.utils import spans as spans_mod
from mcevidence_tpu_torch.utils.spans import collect, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFBENCH = os.path.join(ROOT, "perfbench")
KMAX = 5

KEYS = {
    "refine": {"ingest_s", "evidence_s", "whiten_s", "knn_s", "estimator_s",
               "host_prep_s", "upload_s", "select_s", "host_refine_s"},
    "device": {"ingest_s", "evidence_s", "fused_s", "device_prep_s",
               "upload_s", "device_run_s", "device_fallbacks",
               "device_reruns"},
    "fast": {"ingest_s", "evidence_s", "fused_s"},
}
# the steps that split each precision's layer span, disjoint inside it
STEPS = {"refine": ("knn", ("host_prep", "upload", "select", "host_refine")),
         "device": ("fused", ("device_prep", "upload", "device_run"))}


def _gaussian(n=1500, ndim=4):
    theta, lnl = synthetic_chain(n, ndim, seed=5)
    return theta, lnl


def _lattice():
    # tied distances: the guard reselects at kmax=2
    theta = np.array(list(itertools.product(range(8), repeat=3)), float)
    return theta, -0.5 * np.sum((theta - 3.5) ** 2, axis=1)


CHAINS = {"gaussian": (_gaussian, KMAX), "lattice": (_lattice, 2)}


def _estimate(chain, precision):
    make, kmax = CHAINS[chain]
    theta, lnl = make()
    mce = MCEvidence({"samples": theta, "loglikes": -lnl}, kmax=kmax,
                     precision=precision, device="cpu", verbose=0)
    return mce, mce.evidence()


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _check_tree(spans):
    """Every span lies inside a span of its parent's name."""
    for s in spans:
        if s[1] is not None:
            assert any(p[0] == s[1] and p is not s and _inside(s, p)
                       for p in spans), s


@pytest.mark.parametrize("precision", ["refine", "device", "fast"])
def test_an_estimate_gives_the_documented_keys_in_one_tree(precision):
    mce, _ = _estimate("gaussian", precision)
    assert set(mce.timings) == KEYS[precision]
    names = [s[0] for s in mce.spans]
    assert names[0] == "ingest" and names[-1] == "evidence"
    assert mce.spans[-1][1] is None
    _check_tree(mce.spans)
    # each key is the sum of its spans
    for name in set(names):
        assert mce.timings[name + "_s"] == sum(
            s[3] - s[2] for s in mce.spans if s[0] == name)
    if precision in STEPS:
        layer, steps = STEPS[precision]
        assert (sum(mce.timings[f"{s}_s"] for s in steps)
                <= mce.timings[f"{layer}_s"])
        assert all(s[1] == layer for s in mce.spans if s[0] in steps)


@pytest.mark.parametrize("precision", ["refine", "device"])
@pytest.mark.parametrize("chain", ["gaussian", "lattice"])
def test_the_lattice_reselects_and_the_gaussian_does_not(chain, precision):
    mce, _ = _estimate(chain, precision)
    assert ("reselect_s" in mce.timings) == (chain == "lattice")
    _check_tree(mce.spans)
    layer, steps = STEPS[precision]
    assert (sum(mce.timings[f"{s}_s"] for s in steps)
            <= mce.timings[f"{layer}_s"])
    if chain == "lattice":
        assert mce.timings["reselect_s"] > 0
        again = [s for s in mce.spans if s[0] == "reselect"]
        assert len(again) == 1 and again[0][1] == layer
        # the second pass's steps run inside the reselection; the host
        # prep and the upload (device_prep and upload at device) are not
        # run again
        for step in steps[2:]:
            assert [s[1] for s in mce.spans if s[0] == step] == [
                layer, "reselect"]
        for step in steps[:2]:
            assert [s[1] for s in mce.spans if s[0] == step] == [layer]


def test_a_second_estimate_replaces_the_first_and_keeps_the_ingest():
    mce, first = _estimate("lattice", "refine")
    ingest = mce.spans[0]
    n_spans = len(mce.spans)
    second = mce.evidence()
    np.testing.assert_array_equal(first, second)
    assert mce.spans[0] == ingest and len(mce.spans) == n_spans
    assert mce.timings["knn_s"] == sum(s[3] - s[2] for s in mce.spans
                                       if s[0] == "knn")


def test_the_constructor_records_only_the_ingest():
    theta, lnl = _gaussian()
    mce = MCEvidence({"samples": theta, "loglikes": -lnl}, kmax=KMAX,
                     precision="refine", device="cpu", verbose=0)
    assert set(mce.timings) == {"ingest_s"}
    assert [(s[0], s[1]) for s in mce.spans] == [("ingest", None)]
    ingest = mce.timings["ingest_s"]
    assert ingest == mce.spans[0][3] - mce.spans[0][2] > 0
    mce.evidence()
    assert mce.timings["ingest_s"] == ingest


def _refine_knn(chain):
    make, kmax = CHAINS[chain]
    theta = make()[0]
    white = apply_whiten(theta, whiten_stats(theta))
    return exact_knn(white, None, kmax, device="cpu")


def _device(chain):
    make, kmax = CHAINS[chain]
    theta, lnl = make()
    return device_refine_evidence(theta, lnl, kmax=kmax, device="cpu")


@pytest.mark.parametrize("chain", ["gaussian", "lattice"])
@pytest.mark.parametrize("run", [_refine_knn, _device])
def test_results_are_bit_identical_with_and_without_spans(chain, run):
    bare = run(chain)
    timings, spans = {}, []
    with collect(timings, spans):
        collected = run(chain)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run(chain)
    assert spans and timings
    np.testing.assert_array_equal(bare, collected)
    np.testing.assert_array_equal(bare, traced)


@pytest.mark.parametrize("precision", ["refine", "device", "fast"])
def test_lnz_is_bit_identical_under_a_profile(precision):
    _, plain = _estimate("lattice", precision)
    with profile(activities=[ProfilerActivity.CPU]):
        _, traced = _estimate("lattice", precision)
    np.testing.assert_array_equal(plain, traced)


def _annotations(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X" and e["name"].startswith("mce.")]


def _innermost_parent(ann, anns):
    around = [a for a in anns if a is not ann and a[1] <= ann[1]
              and ann[2] <= a[2]]
    return min(around, key=lambda a: a[2] - a[1])[0] if around else None


@pytest.mark.parametrize("precision", ["refine", "device"])
def test_a_profile_holds_one_annotation_per_span(precision, tmp_path):
    make, kmax = CHAINS["lattice"]
    theta, lnl = make()
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mce = MCEvidence({"samples": theta, "loglikes": -lnl}, kmax=kmax,
                         precision=precision, device="cpu", verbose=0)
        mce.evidence()
    prof.export_chrome_trace(path)
    anns = sorted(_annotations(path), key=lambda a: (a[1], a[1] - a[2]))
    spans = sorted(mce.spans, key=lambda s: (s[2], s[2] - s[3]))
    assert [a[0] for a in anns] == ["mce." + s[0] for s in spans]
    for a, s in zip(anns, spans):
        parent = _innermost_parent(a, anns)
        assert parent == (None if s[1] is None else "mce." + s[1])


def test_the_documented_profile_trace_carries_the_spans(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("MCE_PROFILE_DIR", str(tmp_path))
    mce, _ = _estimate("gaussian", "refine")
    plain = mce.evidence()
    assert not os.listdir(tmp_path)
    traced = mce.evidence(profile=True)
    np.testing.assert_array_equal(plain, traced)
    (name,) = os.listdir(tmp_path)
    anns = _annotations(str(tmp_path / name))
    # the estimate's spans; the ingest ran in the constructor, untraced
    assert sorted(a[0] for a in anns) == sorted(
        "mce." + s[0] for s in mce.spans[1:])


def test_no_record_function_is_entered_without_a_profile(monkeypatch):
    entered = []
    real = spans_mod.record_function

    def counting(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(spans_mod, "record_function", counting)
    for precision in ("refine", "device"):
        mce, _ = _estimate("lattice", precision)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        mce, _ = _estimate("lattice", "device")
    assert sorted(entered) == sorted("mce." + s[0] for s in mce.spans)


def test_a_span_records_only_into_its_own_threads_collector():
    timings, spans, other = {}, [], []

    def elsewhere():
        with span("upload"):
            other.append(spans_mod._ACTIVE.get())
    with collect(timings, spans):
        with span("evidence"):
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert other == [None]
    assert [s[0] for s in spans] == ["evidence"]
    assert set(timings) == {"evidence_s"}


def test_a_device_count_is_read_once_when_its_block_ends():
    """A kernel's counter (here on the CPU) is handed out once a block and
    name, and read into the collector and those around it when the block
    ends; with no collector there is none, and a block that raises reads
    nothing."""
    assert spans_mod.device_count("select_rechecks", "cpu") is None
    outer, inner = {}, {}
    with collect(outer, []):
        with collect(inner, []):
            c = spans_mod.device_count("select_rechecks", "cpu")
            assert c is spans_mod.device_count("select_rechecks", "cpu")
            c += 40
            c += 2
            assert "select_rechecks" not in inner
        assert inner == {"select_rechecks": 42}
        assert outer == {"select_rechecks": 42}
        spans_mod.device_count("select_rechecks", "cpu").add_(8)
    assert outer == {"select_rechecks": 50}
    failed = {}
    with pytest.raises(ValueError):
        with collect(failed, []):
            spans_mod.device_count("select_rechecks", "cpu").add_(1)
            raise ValueError
    assert failed == {}


def test_a_span_without_a_collector_records_nothing():
    with span("select") as s:
        pass
    assert s._col is None
    # and an exception leaves the collector's open spans balanced
    timings, spans = {}, []
    with collect(timings, spans):
        with pytest.raises(ValueError):
            with span("knn"):
                raise ValueError
        with span("estimator"):
            pass
    assert [(s[0], s[1]) for s in spans] == [("knn", None),
                                             ("estimator", None)]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"),
        os.path.join(PERFBENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, PERFBENCH)       # the readers import devtrace
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(PERFBENCH)
    return mod.read


NEW_METRICS = ("upload_ms.chain", "select_ms.refine", "host_refine_ms.refine",
               "reselect_ms.chain", "device_prep_ms.device",
               "device_run_ms.device", "idle_unspanned_pct.chain",
               "host_prep_ms.refine")


class _Tracer:
    def __init__(self, events):
        self.done, self.events = True, events


def _event(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_reader_is_silent_where_the_program_has_no_spans(name):
    # the timings and trace of a program that has no spans yet
    old = {"ingest_s": 0.001, "knn_s": 0.1, "whiten_s": 0.01,
           "estimator_s": 0.01}
    events = [_event("perfbench.estimate", 0, 100),
              _event("perfbench.evidence", 5, 90),
              _event("knn", 40, 5, cat="kernel")]
    readings = {"units": [{"timings": old}] * 3, "tracer": _Tracer(events)}
    assert _reader(name)(readings) is None


def test_the_unspanned_idle_share_counts_the_gaps_outside_the_steps():
    # estimate 0-100 and 200-300 us; kernels 40-50 and 240-250; steps
    # cover 10-45 and 210-260; the root span covers everything
    events = [_event("perfbench.estimate", 0, 100),
              _event("perfbench.estimate", 200, 100),
              _event("mce.evidence", 0, 300),
              _event("mce.knn", 10, 35), _event("mce.knn", 210, 50),
              _event("k", 40, 10, cat="kernel"),
              _event("k", 240, 10, cat="gpu_memcpy")]
    value = _reader("idle_unspanned_pct.chain")(
        {"tracer": _Tracer(events)})
    # idle 180 us: uncovered 0-10, 50-100, 200-210, 260-300 = 110 us
    assert value == pytest.approx(100.0 * 110 / 180)


def test_reselect_counts_the_estimates_that_did_not_reselect_as_zero():
    units = [{"timings": {"evidence_s": 0.1, "reselect_s": 0.04}},
             {"timings": {"evidence_s": 0.1}},
             {"timings": {"evidence_s": 0.1}},
             {"timings": {"evidence_s": 0.1}}]
    assert _reader("reselect_ms.chain")({"units": units}) == \
        pytest.approx(10.0)


@pytest.fixture(scope="module")
def tiny_copy(tmp_path_factory):
    sys.path.insert(0, os.path.join(PERFBENCH, "tests"))
    try:
        from pb_copy import make_copy, run
    finally:
        sys.path.pop(0)
    return make_copy(str(tmp_path_factory.mktemp("checkout"))), run


@pytest.mark.parametrize("cell", ["tiny-refine", "tiny-device"])
def test_a_traced_tiny_cell_reports_every_new_metric(tiny_copy, cell):
    dst, run = tiny_copy
    rc, last, err = run(dst, "--workload", cell, "--seed", "2147483659",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"]
    with open(os.path.join(dst, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    listed = {m["name"] for m in spec["per_layer"]
              if cell in m.get("workloads", ())}
    assert set(NEW_METRICS) & listed <= set(last["metrics"])
    assert len(set(NEW_METRICS) & listed) == {"tiny-refine": 6,
                                              "tiny-device": 5}[cell]
    m = {k: v["value"] for k, v in last["metrics"].items()}
    assert 0 <= m["idle_unspanned_pct.chain"] <= 100
    assert m["reselect_ms.chain"] >= 0
    if cell == "tiny-refine":
        assert (m["host_prep_ms.refine"] + m["upload_ms.chain"]
                + m["select_ms.refine"] + m["host_refine_ms.refine"]
                <= m["knn_ms.refine"])
    else:
        assert (m["device_prep_ms.device"] + m["upload_ms.chain"]
                + m["device_run_ms.device"] <= m["fused_ms.device"])
