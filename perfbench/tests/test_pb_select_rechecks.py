"""``select_rechecks_per_row.chain``'s reader on recorded estimates, and on
a traced run of a tiny chain cell on the CPU, where no kernel counts (the
plain selection runs), so the line leaves the metric out."""

import os

import pytest

from pb_copy import REPO, make_copy, run, tiny_cell_names
from test_pb_harness import load

READER = os.path.join(REPO, "perfbench", "metrics",
                      "select_rechecks_per_row.chain.py")


def reading(*timings):
    return load(READER, "select_rechecks_per_row").read(
        {"units": [{"timings": t} for t in timings]})


@pytest.mark.parametrize("timings, want", [
    # two estimates: (300 + 500) / (2 + 2)
    (({"select_rechecks": 300, "select_rows": 2},
      {"select_rechecks": 500, "select_rows": 2}), 200.0),
    # a reselection's large-k launch counts no rows and no rechecks
    (({"select_rechecks": 90, "select_rows": 1, "reselect_s": 0.1},), 90.0),
    # a program without the counts, or an estimate with no small-k launch
    (({"fused_s": 0.5},), None),
    (({"select_rechecks": 0, "select_rows": 0},), None),
])
def test_the_reader_gives_rechecks_per_row_or_nothing(timings, want):
    assert reading(*timings) == want


def test_a_traced_cpu_run_leaves_the_metric_out(tmp_path):
    copy = make_copy(str(tmp_path / "checkout"))
    cell = tiny_cell_names("chain")[0]
    rc, last, err = run(copy, "--workload", cell, "--seed", "3000000029",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"]
    assert "select_rechecks_per_row.chain" not in last["metrics"]
