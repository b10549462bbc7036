"""Compare two Planck-grid output trees cell by cell.

The counterpart of the repository's ``scripts/compare_grids.py``, and the
comparator of the golden regression: run a reference driver and this
package's grid driver (``python -m mcevidence_tpu_torch.planck``) on the
same grid, then

    python -m mcevidence_tpu_torch.compare_grids <ref_out> <ours_out> [tol]

AllChains mode compares the AllChains column; SingleChains (-nc) outputs
compare every chain<i> column plus Mean_lnE_k1/Err_lnE_k1.  Exits 1 when
any |d lnE| exceeds tol (default 1e-6), 2 when the trees share no
per-dataset csv or the arguments are missing, 0 otherwise.  It reads
tables only: no device, no torch.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import pandas as pd


def compare(ref_dir: str, ours_dir: str, tol: float = 1e-6) -> int:
    pairs = []
    for mode in ("AllChains", "SingleChains"):
        for f in sorted(glob.glob(os.path.join(ref_dir, mode, "csv",
                                               "mce_*.csv"))):
            g = os.path.join(ours_dir, mode, "csv", os.path.basename(f))
            if os.path.exists(g):
                pairs.append((mode, f, g))
    if not pairs:
        print("no comparable per-dataset csvs found", file=sys.stderr)
        return 2
    maxd, ncells, worst = 0.0, 0, None
    for mode, f, g in pairs:
        ref = pd.read_csv(f, index_col=0)
        ours = pd.read_csv(g, index_col=0)
        cols = [c for c in ref.columns
                if c == "AllChains" or c.startswith("chain")
                or c in ("Mean_lnE_k1", "Err_lnE_k1") or c.startswith("lnE")]
        for model in ref.index:
            for c in cols:
                a = ref.loc[model, c]
                b = (ours.loc[model, c]
                     if model in ours.index and c in ours.columns else np.nan)
                if np.isnan(a) and np.isnan(b):
                    continue
                d = abs(float(a) - float(b))
                ncells += 1
                if d > maxd:
                    maxd, worst = d, (mode, os.path.basename(f), model, c)
    print(f"{ncells} cells compared over {len(pairs)} csv pairs; "
          f"max |d lnE| = {maxd:.3e} at {worst}")
    if maxd > tol:
        print(f"FAIL: exceeds tol {tol:g}", file=sys.stderr)
        return 1
    print(f"OK: within tol {tol:g}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    return compare(argv[0], argv[1], float(argv[2]) if len(argv) > 2
                   else 1e-6)


if __name__ == "__main__":
    sys.exit(main())
