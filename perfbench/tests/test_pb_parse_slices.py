"""``parse_slices_per_file.grid``'s reader on recorded passes, and on a
traced run of the tiny grid cell, whose files are each under the parser's
slice minimum and so decode in one slice."""

import os

import pytest

from pb_copy import REPO, run
from test_pb_grid import CELL, make_grid_copy
from test_pb_harness import load

READER = os.path.join(REPO, "perfbench", "metrics",
                      "parse_slices_per_file.grid.py")


def reading(*timings):
    return load(READER, "parse_slices_per_file").read(
        {"units": [{"timings": t} for t in timings]})


@pytest.mark.parametrize("timings, want", [
    # two passes: (12 + 20) / (4 + 8)
    (({"grid_cells": 12, "parse_files": 4, "parse_slices": 12},
      {"grid_cells": 12, "parse_files": 8, "parse_slices": 20}),
     32 / 12),
    # a pass with no grid counts is not the grid's: nothing to read
    (({"parse_files": 4, "parse_slices": 12},), None),
    # no file parsed (the parse cache), or a program without the counts
    (({"grid_cells": 12, "parse_files": 0, "parse_slices": 0},), None),
    (({"grid_cells": 12, "parse_fields": 70, "parse_fields_fixed": 70},),
     None),
])
def test_the_reader_gives_slices_per_file_or_nothing(timings, want):
    got = reading(*timings)
    assert got == (None if want is None else pytest.approx(want))


def test_a_traced_tiny_grid_reads_one_slice_a_file(tmp_path):
    copy = make_grid_copy(str(tmp_path / "checkout"))
    rc, last, err = run(copy, "--workload", CELL, "--seed", "3000000023",
                        "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    assert last["correct"]
    assert last["metrics"]["parse_slices_per_file.grid"]["value"] == 1.0
