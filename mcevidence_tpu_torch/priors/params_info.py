"""Prior metadata: parameter names, ranges, and prior-space volume.

Parses CosmoMC ``<root>.ranges`` files and MontePython ``<dir>/log.param``
files (reference MCEvidence.py:1173-1272) and computes the flat-prior volume
as the product of parameter ranges.  ``get_prior_volume`` implements the
reference CLI's behaviour with the fallback-to-unity path actually reachable
(the reference's is dead code behind a bare ``raise`` — quirk Q5).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import logging
from typing import Dict, List, Optional

import numpy as np

from ..registry import iscosmo_param

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ParamsInfo:
    names: List[str]
    mins: List[float]
    maxs: List[float]
    ranges: List[float]
    nr_of_params: int

    @property
    def ndim(self) -> int:
        return len(self.names)

    @property
    def volume(self) -> float:
        return float(np.prod(np.asarray(self.ranges, dtype=np.float64)))

    def as_dict(self) -> Dict:
        """Reference-shaped dict (MCEvidence.py:1266-1272)."""
        return {"name": self.names, "min": self.mins, "max": self.maxs,
                "range": self.ranges, "str": ",".join(self.names),
                "ndim": self.ndim, "nr_of_params": self.nr_of_params,
                "volume": self.volume}


def _parse_ranges_file(path: str, cosmo: bool) -> ParamsInfo:
    """CosmoMC ``.ranges``: whitespace columns ``name  min  max``; 'N' means
    unbounded (treated as +/-inf); rows with min==max are fixed parameters and
    skipped (reference MCEvidence.py:1213-1230)."""
    info = ParamsInfo([], [], [], [], 0)
    with open(path, "r") as fp:
        for raw in fp:
            parts = raw.split()
            if len(parts) < 3:
                continue
            name = parts[0]
            pmin = -np.inf if parts[1] == "N" else float(parts[1])
            pmax = np.inf if parts[2] == "N" else float(parts[2])
            if cosmo and not iscosmo_param(name):
                continue
            if np.isclose(pmax, pmin):
                continue
            info.names.append(name)
            info.mins.append(pmin)
            info.maxs.append(pmax)
            info.ranges.append(abs(pmax - pmin))
            info.nr_of_params += 1
    return info


def _parse_montepython_value(tok: str):
    tok = tok.strip().strip('"').strip("'")
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


def parse_log_param_line(line: str):
    """Parse one ``data.parameters['name'] = [min, max, ...]`` line
    (reference extract_array/extract_dict, MCEvidence.py:1173-1193)."""
    lhs, _, rhs = line.partition("=")
    name = lhs.split("[")[-1].strip().rstrip("]").strip().strip('"').strip("'")
    rhs = rhs.strip().strip("]").lstrip("[")
    seq = [_parse_montepython_value(e) for e in rhs.split(",")]
    return name, seq


def _parse_log_param_file(path: str, cosmo: bool) -> ParamsInfo:
    """MontePython ``log.param``: keeps non-derived parameters (optionally
    only role=='cosmo'); rejects unbounded priors (reference
    MCEvidence.py:1233-1262)."""
    info = ParamsInfo([], [], [], [], 0)
    with open(path, "r") as fp:
        for line in fp:
            # Strip trailing comments FIRST: a commented-out parameter line
            # becomes empty and is skipped, while a valid line with an
            # inline `# note` is still parsed.  (The reference skipped any
            # line containing '#' anywhere, MCEvidence.py:1239, silently
            # dropping valid rows and biasing the volume by -ln(range) —
            # deviation recorded in PARITY.md.)
            line = line.split("#", 1)[0]
            if "data.parameters" not in line:
                continue
            name, arr = parse_log_param_line(line)
            if len(arr) < 6:
                continue
            role = arr[5]
            if role == "derived":
                continue
            if cosmo and role != "cosmo":
                continue
            info.nr_of_params += 1
            if arr[1] == "None" or arr[2] == "None":
                raise ValueError(
                    "Unbounded priors are not supported - please specify "
                    f"priors (parameter {name!r} in {path})")
            vmin, vmax = float(arr[1]), float(arr[2])
            info.names.append(name)
            info.mins.append(vmin)
            info.maxs.append(vmax)
            info.ranges.append(vmax - vmin)
    return info


def params_info(fname: str, cosmo: bool = False) -> ParamsInfo:
    """Extract parameter names/ranges/volume from ``<fname>*.ranges`` (CosmoMC)
    or ``<fname>/log.param`` (MontePython); reference MCEvidence.py:1204-1272."""
    ranges_matches = _glob.glob(f"{fname}*.ranges")
    if ranges_matches:
        path = (f"{fname}.ranges"
                if f"{fname}.ranges" in ranges_matches else ranges_matches[0])
        logger.info("params info from CosmoMC file %s", path)
        info = _parse_ranges_file(path, cosmo)
    else:
        lp = f"{fname}/log.param"
        if _glob.glob(lp):
            logger.info("params info from MontePython file %s", lp)
            info = _parse_log_param_file(lp, cosmo)
        else:
            from ..chains.cobaya import cobaya_params_info, updated_yaml_path
            cy = updated_yaml_path(fname)
            if cy is None:
                raise FileNotFoundError(
                    "Could not read parameter volume from CosmoMC .ranges, "
                    "MontePython log.param, or Cobaya updated.yaml files "
                    f"for root {fname!r}")
            logger.info("params info from Cobaya file %s", cy)
            info = cobaya_params_info(fname, cosmo)
    # An empty match would otherwise flow downstream as volume=prod([])=1
    # and ndim=0, running the estimator on zero-column samples.  (The
    # reference proceeded silently here and crashed obscurely later.)
    if info.ndim == 0:
        hint = (" with the cosmological-parameter filter active; pass "
                "--allparams / cosmo=False, or extend the registry via "
                "--paramsfile" if cosmo else "")
        raise ValueError(
            f"no usable (varying) parameters found for root {fname!r}{hint}")
    return info


def get_prior_volume(root_name: str, cosmo: bool = True,
                     priorvolume: Optional[float] = None,
                     allow_unit_fallback: bool = False):
    """Prior volume for a chain root.

    Returns (volume, ndim_or_None).  If metadata files are missing: use the
    explicit ``priorvolume`` if given, else fall back to volume=1 when
    ``allow_unit_fallback`` (model comparison then absorbs the prior ratio),
    else re-raise.  This makes the reference's intended-but-dead fallback
    (MCEvidence.py:1312-1339, quirk Q5) an explicit, non-interactive option.
    """
    try:
        info = params_info(root_name, cosmo=cosmo)
        logger.info("prior_volume=%s ndim=%s (%s)", info.volume, info.ndim,
                    info.as_dict()["str"])
        return info.volume, info.ndim
    except (FileNotFoundError, ValueError):
        if priorvolume is not None:
            return float(priorvolume), None
        if allow_unit_fallback:
            logger.warning("no prior metadata found for %s: using "
                           "prior_volume=1 (results include the prior ratio)",
                           root_name)
            return 1.0, None
        raise
