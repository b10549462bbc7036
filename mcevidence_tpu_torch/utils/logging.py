"""Logging configuration shared across the package.

Format and verbosity mapping follow the reference (MCEvidence.py:62-64,
659-671): verbose 0/1/2 -> WARNING/INFO/DEBUG.
"""

from __future__ import annotations

import logging

FORMAT = "%(levelname)s:%(filename)s.%(funcName)s():%(lineno)-8s %(message)s"


def verbosity_to_level(verbose: int) -> int:
    if verbose <= 0:
        return logging.WARNING
    if verbose == 1:
        return logging.INFO
    return logging.DEBUG


def configure(verbose: int = 1) -> None:
    logging.basicConfig(level=verbosity_to_level(verbose), format=FORMAT)
    logging.getLogger("mcevidence_tpu_torch").setLevel(verbosity_to_level(verbose))
