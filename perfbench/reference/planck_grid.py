"""The ln Z table of one Planck grid dataset in AllChains mode, written
plainly, as ``planck_mcevidence.py`` (Heavens et al., arXiv:1704.03467)
computes it over CosmoMC text files.

For each model: its chain files read with ``np.loadtxt`` and stacked
(``_1.txt`` to ``_<nfiles>.txt`` in order); the first ndim parameter
columns, ndim being the number of cosmological parameters ``.ranges``
bounds (a row with min = max is a fixed parameter and left out); the prior
volume the product of their ranges, over the ``base`` model's
(planck_mcevidence.py:324-331); SumW reweighted by the Riess et al. (2016)
H0 Gaussian over the ``H0*`` column that ``.paramnames`` names
(planck_mcevidence.py:56-58); and ln Z of ``knn_evidence.log_evidence``
with them.  It shares no code with the program.
"""

import numpy as np

from reference.knn_evidence import log_evidence

# the cosmological parameter names of MCEvidence.py:84-86
COSMO_PARAMS = (
    "omegabh2", "omegach2", "theta", "tau", "omegak", "mnu", "meffsterile",
    "w", "wa", "nnu", "yhe", "alpha1", "deltazrei", "Alens", "Alensf", "fdm",
    "logA", "ns", "nrun", "nrunrun", "r", "nt", "ntrun", "Aphiphi",
)
H0_MEAN, H0_ERR = 73.24, 1.74


def cosmo_ranges(root):
    """[(name, min, max)] of the cosmological parameters ``root.ranges``
    bounds, fixed ones left out."""
    out = []
    with open(root + ".ranges") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3 or parts[0] not in COSMO_PARAMS:
                continue
            lo = -np.inf if parts[1] == "N" else float(parts[1])
            hi = np.inf if parts[2] == "N" else float(parts[2])
            if not np.isclose(lo, hi):
                out.append((parts[0], lo, hi))
    return out


def h0_column(root):
    """The index of ``H0*`` among the parameters of ``root.paramnames``."""
    with open(root + ".paramnames") as fh:
        names = [ln.split()[0].rstrip("*") for ln in fh if ln.split()]
    return names.index("H0")


def model_lnz(root, nfiles, kmax, device, vol_base=1.0, h0_prior=True):
    """ln Z for k = 1..kmax-1 of one model's chains ``root_1.txt`` to
    ``root_<nfiles>.txt`` combined."""
    table = np.vstack([np.loadtxt(f"{root}_{i}.txt", ndmin=2)
                       for i in range(1, nfiles + 1)])
    w, lnl, params = table[:, 0], -table[:, 1], table[:, 2:]
    ranges = cosmo_ranges(root)
    volume = float(np.prod([hi - lo for _, lo, hi in ranges]))
    sumw = None
    if h0_prior:
        h0 = params[:, h0_column(root)]
        sumw = float(np.sum(w * np.exp(-0.5 * ((h0 - H0_MEAN) / H0_ERR)
                                       ** 2)))
    return log_evidence(params[:, :len(ranges)], lnl, w, kmax, device,
                        sumw=sumw, prior_volume=volume / vol_base)


def dataset_table(rootdir, dataset, models, nfiles, kmax, device):
    """{model: ln Z for k = 1..kmax-1} of every model, with the prior
    volumes over ``base``'s where ``base`` is among them."""
    roots = {m: f"{rootdir}/{m}/{dataset}/{m}_{dataset}" for m in models}
    vol_base = 1.0
    if "base" in roots:
        vol_base = float(np.prod([hi - lo for _, lo, hi
                                  in cosmo_ranges(roots["base"])]))
    return {m: model_lnz(r, nfiles, kmax, device, vol_base)
            for m, r in roots.items()}
