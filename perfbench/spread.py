#!/usr/bin/env python3
"""The spread of each metric over runs, as the bounds are set from it.

    python3 perfbench/spread.py <file with one result line a run>...

Each file holds one set of runs of one cell (the last line of each run's
standard output, one a line).  For each metric it prints the median and
the spread: the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median.  Given
two or more sets of one cell, it prints for each metric also the widest
set's spread, the mean of the sets' spreads with each set's run farthest
from its median left out, and the spread of all the runs together.
"""

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(paths):
    sets = []
    for path in paths:
        with open(path) as fh:
            runs = [json.loads(ln) for ln in fh if ln.strip()]
        sets.append(runs)
        print(f"{path}: {len(runs)} runs, correct "
              f"{sum(r['correct'] for r in runs)}")
        for name in runs[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in runs]
            print(f"  {name}: median {statistics.median(vals)!r} spread "
                  f"{spread(vals):.4f} values {vals}")
    if len(sets) > 1:
        print("over the sets:")
        for name in sets[0][0]["metrics"]:
            per = [[r["metrics"][name]["value"] for r in s] for s in sets]
            print(f"  {name}: widest set {max(map(spread, per)):.4f}, "
                  f"trimmed mean {statistics.mean(spread(trimmed(v)) for v in per):.4f}, "
                  f"all runs {spread(sum(per, [])):.4f}, medians "
                  f"{[statistics.median(v) for v in per]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
