"""Generate a synthetic Planck full grid at the published run's real sizes.

The counterpart of the repository's ``scripts/synth_grid.py``.  Reads the
golden AllChains tables of a published grid run
(``<golden_csv_dir>/mce_<dataset>.csv``) to get every populated
(dataset, model) cell's chain length, cosmological dimensionality and
base-normalised prior volume, then writes a CosmoMC-layout chain grid
(``<out>/<model>/<dataset>/<model>_<dataset>_{1..4}.txt`` + ``.ranges`` +
``.paramnames`` with a derived ``H0*`` column for the Riess-2016 importance
hook) with Gaussian chains of exactly those shapes, from the generator
seed 20260816.  The same tables give the same files, byte for byte, as the
repository's script.

Usage::

    python -m mcevidence_tpu_torch.synth_grid <outdir> <golden_csv_dir>

Both arguments are required.  It writes files only: no device, no torch.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import pandas as pd

# names present in both frameworks' cosmological-parameter registries
PARAM_NAMES = ["omegabh2", "omegach2", "theta", "tau", "omegak", "mnu",
               "w", "nnu", "yhe"]
NCHAINS = 4
SEED = 20260816


def golden_cells(csv_dir: str):
    cells = []
    for f in sorted(glob.glob(os.path.join(csv_dir, "*.csv"))):
        df = pd.read_csv(f, index_col=0)
        ds = os.path.basename(f).split("mce_", 1)[-1][:-4]
        for model, row in df.iterrows():
            nr = str(row["N_read"]).strip().strip(",")
            if not nr or nr == "nan":
                continue
            n = sum(int(x) for x in nr.split(",") if x)
            cells.append((ds, str(model), n, int(row["ndim"]),
                          float(row["PriorVol"])))
    return cells


def write_cell(outdir, ds, model, n, ndim, prior_vol, rng):
    d = os.path.join(outdir, model, ds)
    os.makedirs(d, exist_ok=True)
    root = os.path.join(d, f"{model}_{ds}")
    names = PARAM_NAMES[:ndim]
    mean = np.linspace(1.0, 2.0, ndim)
    sig = np.full(ndim, 0.05)
    widths = np.ones(ndim)
    widths[-1] = max(prior_vol, 1e-3)          # volume = prod(widths)
    per = [n // NCHAINS] * NCHAINS
    per[0] += n - sum(per)
    for c, nc in enumerate(per, start=1):
        theta = rng.normal(mean, sig, size=(nc, ndim))
        dm = (theta - mean) / sig
        neglnl = (0.5 * np.sum(dm * dm, axis=1)
                  + 0.5 * ndim * np.log(2 * np.pi) + np.sum(np.log(sig)))
        h0 = rng.normal(70.0, 3.0, size=nc)     # derived H0* column
        cols = np.column_stack([np.ones(nc), neglnl, theta, h0])
        df = pd.DataFrame(cols)
        df.to_csv(f"{root}_{c}.txt", sep=" ", header=False, index=False,
                  float_format="%.7e")
    with open(root + ".ranges", "w") as f:
        for nm, mu, wd in zip(names, mean, widths):
            f.write(f"{nm} {mu - wd / 2:.6g} {mu + wd / 2:.6g}\n")
        f.write("nuis1 0 0\n")                  # fixed param: must be skipped
    with open(root + ".paramnames", "w") as f:
        for nm in names:
            f.write(f"{nm}\t{nm}\n")
        f.write("H0*\tH_0\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mcevidence_tpu_torch.synth_grid",
        description="write a synthetic Planck grid at the sizes of a "
                    "published run's golden AllChains tables")
    p.add_argument("outdir")
    p.add_argument("golden_csv_dir",
                   help="directory of the published mce_<dataset>.csv "
                        "AllChains tables")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    cells = golden_cells(args.golden_csv_dir)
    rng = np.random.default_rng(SEED)
    total = 0
    for i, (ds, model, n, ndim, pv) in enumerate(cells):
        write_cell(args.outdir, ds, model, n, ndim, pv, rng)
        total += n
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{len(cells)} cells, {total} rows", flush=True)
    print(f"done: {len(cells)} cells, {total} rows -> {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
