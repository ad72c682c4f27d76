"""The photon configuration's size on the CPU, for the benchmark's tests
that run every cell small (``portbench/tests/conftest.py``'s
``small_of``)."""

import copy

from portbench import registry
from portbench.tests import conftest as tests_conftest


def small_photon(photons=2048, check_points=6):
    """nicer-j0030-photon at a size the CPU holds: fewer photons, the
    same template, span and par file."""
    cfg = registry.config("nicer-j0030-photon")
    a = copy.deepcopy(cfg["assumed"])
    a["photons"] = photons
    return {"assumed": a, "check_points": check_points}


tests_conftest.SMALL.setdefault(
    "nicer-j0030-photon", (small_photon(), {"nwalkers": 8, "steps": 2}))
