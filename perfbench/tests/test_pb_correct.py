"""The check that decides ``correct``, shown to fail: the control (the
program's own lower-precision path in the program's place) and the
faults a cell can have, each planted under the timed path of a tiny cell
on the CPU, must read ``correct`` false.

The faults: an answer altered where it is produced (one estimate), and
half of the batch left out with the mean taken over the rest (half of a
chain's rows).  A
state returned unchanged (no cell trains) and the exchange between chips
(every cell takes one chip) cannot occur in these cells.
"""

import numpy as np
import pytest

import run as harness
from pb_copy import TINY_CELLS, make_copy, tiny_cell_names

CONTROL = {c[0]: c[4] for c in TINY_CELLS}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("checkout")))


def run_tiny(copy, cell, seed=2147483647, overrides=None):
    return harness.run_cell(cell, seed, 0.5, 0, "cpu", overrides=overrides,
                            root=copy)


@pytest.mark.parametrize("cell", tiny_cell_names())
def test_the_program_passes_and_the_control_fails(copy, cell):
    assert run_tiny(copy, cell)["correct"]
    control = run_tiny(copy, cell, overrides=CONTROL[cell])
    assert not control["correct"]
    assert any(c["value"] > c["limit"] for c in control["checks"].values())


def every_nth_call(n, alter):
    """A wrapper factory: every n-th call's result goes through ``alter``
    (so that some fall into the window, past the set-up's calls)."""
    def altered(orig):
        calls = [0]

        def fn(*a, **k):
            calls[0] += 1
            out = orig(*a, **k)
            return alter(out) if calls[0] % n == 0 else out
        return fn
    return altered


def plus(eps):
    return lambda out: np.asarray(out, np.float64) + eps


def half_rows_estimator(orig):
    def fn(dknn, lnlike, weights, sumw, ndim, **k):
        h = len(lnlike) // 2
        k["nsamples"] = h
        return orig(dknn[:h], lnlike[:h], weights[:h], sumw, ndim, **k)
    return fn


def half_rows_device(orig):
    def fn(samples, lnlike, weights, **k):
        h = len(lnlike) // 2
        return orig(samples[:h], lnlike[:h], weights[:h], **k)
    return fn


# (tiny cell, module, attribute, wrapper)
FAULTS = [
    ("tiny-refine", "mcevidence_tpu_torch.evidence",
     "log_evidence_from_knn_np", every_nth_call(5, plus(1e-6))),
    ("tiny-refine", "mcevidence_tpu_torch.evidence",
     "log_evidence_from_knn_np", half_rows_estimator),
    ("tiny-device", "mcevidence_tpu_torch.ops.pipeline",
     "device_refine_evidence", every_nth_call(5, plus(1e-6))),
    ("tiny-device", "mcevidence_tpu_torch.ops.pipeline",
     "device_refine_evidence", half_rows_device),
]


@pytest.mark.parametrize("cell,module,attr,wrapper", FAULTS,
                         ids=[f"{c}-{a}-{w.__name__}"
                              for c, _, a, w in FAULTS])
def test_a_planted_fault_reads_incorrect(copy, monkeypatch, cell, module,
                                         attr, wrapper):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, wrapper(getattr(mod, attr)))
    assert not run_tiny(copy, cell)["correct"]
