"""One dataset of the Planck R2 full grid, written as CosmoMC writes it.

The layout the grid driver globs, for each model of the configuration:

    <root>/<model>/<dataset>/<model>_<dataset>_{1..nfiles}.txt
    <root>/<model>/<dataset>/<model>_<dataset>.paramnames
    <root>/<model>/<dataset>/<model>_<dataset>.ranges

A record is ``weight  -lnL  params...``, every number as ``%16.7E``, with
the parameters in ``.paramnames`` order: the six base cosmological
parameters, the model's extension parameters, the plik nuisance
parameters, then the derived parameters (marked ``*``), ``H0*`` among them.
Each record has the configuration's ``columns`` numbers.

Each model's posterior is a correlated Gaussian over its cosmological
parameters, centred near the configuration's centres at about its widths,
with ``-lnL`` its own normalised log density plus a constant; the weights
are integers; ``H0*`` is a smooth function of the cosmological point, so
that the H0 importance weight varies from row to row.  As in
``gen_chain.py``, the standard-normal points come from the configuration's
fixed ``structure_seed`` and the seed draws everything else, so every seed
has the same whitened neighbour structure and the same work.

The text is formatted in bulk (fixed-width fields built with numpy), which
is some ten times faster than ``np.savetxt``.
"""

import math
import os

import numpy as np

from gen_chain import correlated_gaussian, rng_for

FIELD = 16      # bytes of one number: "%16.7E"


def format_rows(a):
    """The rows of ``a`` as ``%16.7E`` fields, one row a line, as bytes."""
    a = np.asarray(a, np.float64)
    if not np.all(np.isfinite(a)):
        raise ValueError("a value to write is not finite")
    n, c = a.shape
    mag = np.abs(a)
    nz = mag > 0
    e = np.zeros(a.shape, np.int64)
    e[nz] = np.floor(np.log10(mag[nz])).astype(np.int64)
    mant = np.where(nz, mag / 10.0 ** e, 0.0)
    e += (mant >= 10.0)
    e -= (mant < 1.0) & nz
    m = np.rint(np.where(nz, mag / 10.0 ** e, 0.0) * 1e7).astype(np.int64)
    carry = m >= 100000000          # 9.99999996 rounds to 10.0000000
    m[carry] //= 10
    e[carry] += 1
    if np.any(np.abs(e) > 99):
        raise ValueError("an exponent needs three digits")
    out = np.empty((n, c, FIELD), np.uint8)
    out[..., 0:2] = ord(" ")
    out[..., 2] = np.where(a < 0, ord("-"), ord(" "))
    for i, pos in enumerate((3, 5, 6, 7, 8, 9, 10, 11)):
        out[..., pos] = ord("0") + (m // 10 ** (7 - i)) % 10
    out[..., 4] = ord(".")
    out[..., 12] = ord("E")
    out[..., 13] = np.where(e < 0, ord("-"), ord("+"))
    ae = np.abs(e)
    out[..., 14] = ord("0") + ae // 10
    out[..., 15] = ord("0") + ae % 10
    lines = np.empty((n, c * FIELD + 1), np.uint8)
    lines[:, :-1] = out.reshape(n, c * FIELD)
    lines[:, -1] = ord("\n")
    return lines.tobytes()


def model_rows(cfg):
    """{model: rows of all its files}: log-spaced from ``rows[0]`` to
    ``rows[1]`` over the models, in their order."""
    lo, hi = cfg["rows"]
    models = cfg["models"]
    if len(models) == 1:
        return {models[0]: lo}
    return {m: int(round(lo * (hi / lo) ** (i / (len(models) - 1))))
            for i, m in enumerate(models)}


def model_params(cfg, model):
    """(cosmological, nuisance, derived) parameter names of a model: the
    base six, then the extensions its name lists; the derived names fill
    the record to ``columns``."""
    cosmo = list(cfg["base_params"]) + model.split("_")[1:]
    nuis = list(cfg["nuisance_params"])
    nder = cfg["columns"] - 2 - len(cosmo) - len(nuis)
    derived = list(cfg["derived_params"][:nder])
    if len(derived) != nder or "H0" not in derived:
        raise ValueError(f"{model}: {nder} derived columns needed, with H0")
    return cosmo, nuis, derived


def write_model(root, cfg, model, nrows, points, rng):
    """Write one model's chain files, ``.paramnames`` and ``.ranges``;
    returns (ndim, rows)."""
    cosmo, nuis, derived = model_params(cfg, model)
    d = len(cosmo)
    centre = np.array([cfg["posterior"][p][0] for p in cosmo])
    width = np.array([cfg["posterior"][p][1] for p in cosmo])
    scales = width * 10.0 ** rng.uniform(-0.1, 0.1, d)
    mean = centre + 0.2 * width * rng.normal(size=d)
    chol = correlated_gaussian(rng, d, scales)
    z = points.standard_normal((nrows, d))[rng.permutation(nrows)]
    theta = mean + z @ chol.T
    lnl = (-0.5 * np.sum(z * z, axis=1) - 0.5 * d * math.log(2 * math.pi)
           - float(np.sum(np.log(np.diag(chol))))
           - rng.uniform(*cfg["minus_lnl_offset"]))
    wmin, wmax = cfg["weights"]
    w = rng.integers(wmin, wmax + 1, size=nrows).astype(np.float64)
    # nuisance: independent Gaussians about centres drawn from the seed
    ncen = 10.0 ** rng.uniform(-1.0, 2.0, len(nuis))
    nwid = ncen * rng.uniform(0.01, 0.2, len(nuis))
    nuis_v = ncen + nwid * rng.normal(size=(nrows, len(nuis)))
    der_v = (10.0 ** rng.uniform(-1.0, 2.0, len(derived))
             * (1.0 + 0.05 * rng.normal(size=(nrows, len(derived)))))
    # H0*: smooth in the cosmological point, so the importance weight varies
    a = rng.normal(size=d)
    u = z @ (a / np.linalg.norm(a))
    h0c, h0s = cfg["h0"]["centre"], rng.uniform(*cfg["h0"]["slope"])
    der_v[:, derived.index("H0")] = h0c + h0s * u + 0.3 * u * u
    table = np.column_stack([w, -lnl, theta, nuis_v, der_v])
    nfiles = cfg["nfiles"]
    bounds = np.linspace(0, nrows, nfiles + 1).round().astype(int)
    for i in range(nfiles):
        with open(f"{root}_{i + 1}.txt", "wb") as fh:
            fh.write(format_rows(table[bounds[i]:bounds[i + 1]]))
    with open(root + ".paramnames", "w") as fh:
        for p in cosmo + nuis:
            fh.write(f"{p}\t{p}\n")
        for p in derived:
            fh.write(f"{p}*\t{p}\n")
    with open(root + ".ranges", "w") as fh:
        for p in cosmo:
            lo, hi = cfg["prior_ranges"][p]
            fh.write(f"{p}\t{lo!r}\t{hi!r}\n")
        for p, v in cfg["fixed_params"].items():
            if p not in cosmo:
                fh.write(f"{p}\t{v!r}\t{v!r}\n")
        for p, c, s in zip(nuis, ncen, nwid):
            fh.write(f"{p}\t{float(c - 20 * s)!r}\t{float(c + 20 * s)!r}\n")
        for p in derived:
            fh.write(f"{p}\tN\tN\n")
    return d, nrows


def write_grid(rootdir, seed, cfg):
    """Write the configuration's dataset under ``rootdir`` from ``seed``;
    returns [(model, ndim, rows)] in the configuration's model order."""
    ds = cfg["dataset"]
    shapes = []
    for i, (model, nrows) in enumerate(model_rows(cfg).items()):
        d = os.path.join(rootdir, model, ds)
        os.makedirs(d, exist_ok=True)
        ndim, n = write_model(os.path.join(d, f"{model}_{ds}"), cfg, model,
                              nrows, rng_for(cfg["structure_seed"], i),
                              rng_for(seed, i))
        shapes.append((model, ndim, n))
    return shapes
