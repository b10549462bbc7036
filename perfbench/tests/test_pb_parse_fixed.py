"""``parse_fixed_pct.grid``'s reader on recorded passes, and on a traced
run of the tiny grid cell, whose ``%16.7E`` text the fixed-layout decoder
takes whole."""

import os

import pytest

from pb_copy import REPO, run
from test_pb_grid import CELL, make_grid_copy
from test_pb_harness import load

READER = os.path.join(REPO, "perfbench", "metrics", "parse_fixed_pct.grid.py")


def reading(*timings):
    return load(READER, "parse_fixed_pct").read(
        {"units": [{"timings": t} for t in timings]})


@pytest.mark.parametrize("timings, want", [
    # two passes: 100 * (70 + 140) / (70 + 210)
    (({"grid_cells": 12, "parse_fields": 70, "parse_fields_fixed": 70},
      {"grid_cells": 12, "parse_fields": 210, "parse_fields_fixed": 140}),
     75.0),
    # a pass with no grid counts is not the grid's: nothing to read
    (({"parse_fields": 70, "parse_fields_fixed": 70},), None),
    # no field parsed (the parse cache, or a program without the counts)
    (({"grid_cells": 12, "parse_fields": 0, "parse_fields_fixed": 0},),
     None),
    (({"grid_cells": 12},), None),
])
def test_the_reader_gives_the_fixed_share_or_nothing(timings, want):
    got = reading(*timings)
    assert got == (None if want is None else pytest.approx(want))


def test_a_traced_tiny_grid_reads_every_field_fixed(tmp_path):
    copy = make_grid_copy(str(tmp_path / "checkout"))
    rc, last, err = run(copy, "--workload", CELL, "--seed", "3000000021",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"]
    assert last["metrics"]["parse_fixed_pct.grid"]["value"] == 100.0
