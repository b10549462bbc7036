"""Cosmological-parameter registry.

The reference hard-codes a list of CosmoMC cosmological parameter names used to
separate cosmological from nuisance parameters when computing prior volumes
(reference: MCEvidence.py:84-86, planck_mcevidence.py:176-178).  We keep one
canonical registry with explicit extension hooks instead of the reference's
mutate-global-on-query behaviour (MCEvidence.py:1195-1202).
"""

from __future__ import annotations

# Canonical CosmoMC cosmological parameter names (reference MCEvidence.py:84-86).
COSMO_PARAMS: tuple[str, ...] = (
    "omegabh2", "omegach2", "theta", "tau", "omegak", "mnu", "meffsterile",
    "w", "wa", "nnu", "yhe", "alpha1", "deltazrei", "Alens", "Alensf", "fdm",
    "logA", "ns", "nrun", "nrunrun", "r", "nt", "ntrun", "Aphiphi",
)

# Mutable extension set (populated by ``extend_cosmo_params`` /
# ``load_params_file``); queries consult COSMO_PARAMS plus this set.
_extra_cosmo_params: set[str] = set()


def extend_cosmo_params(names) -> None:
    """Register additional parameter names as cosmological.

    Mirrors the reference CLI's ``--paramsfile`` extension semantics
    (MCEvidence.py:1422-1435) without mutating the canonical list.
    """
    _extra_cosmo_params.update(str(n) for n in names)


def reset_cosmo_params() -> None:
    """Drop all registered extensions (test hygiene)."""
    _extra_cosmo_params.clear()


def load_params_file(path: str) -> list[str]:
    """Read extra cosmological parameter names from a text file.

    One name per line.  Trailing ``#`` comments are stripped and the
    remainder kept; blank and fully-commented lines are skipped.  (The
    reference skipped any line containing '#' anywhere, MCEvidence.py:
    1424-1428, silently discarding a valid name with an inline comment —
    the same defect fixed in the MontePython log.param parser; see
    docs/PARITY.md.)
    """
    names: list[str] = []
    with open(path, "r") as fp:
        for raw in fp:
            line = raw.split("#", 1)[0].strip()
            if line:
                names.append(line)
    extend_cosmo_params(names)
    return names


def iscosmo_param(p: str, cosmo_params=None) -> bool:
    """True if parameter name ``p`` is cosmological (reference MCEvidence.py:1195-1202).

    ``cosmo_params``: optional extra names to also accept FOR THIS QUERY
    ONLY.  The reference permanently extended its global list here
    (MCEvidence.py:1199-1200), which in a long-lived process leaks one
    request's extensions into every later one, silently inflating prior
    volumes; persistent registration is the explicit hooks' job
    (``extend_cosmo_params`` / ``load_params_file``).
    """
    if cosmo_params is not None and p in {str(n) for n in cosmo_params}:
        return True
    return p in COSMO_PARAMS or p in _extra_cosmo_params
