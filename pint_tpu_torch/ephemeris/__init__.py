"""Solar-system ephemerides.

Replaces astropy.coordinates.solar_system + jplephem (SURVEY.md §2b;
reference: src/pint/solar_system_ephemerides.py objPosVel_wrt_SSB).

Two providers:

- ``kepler`` (default, built-in): analytic Keplerian planetary theory +
  truncated lunar theory. Internally consistent (simulate→fit exact) but
  ~tens of ms absolute Roemer accuracy vs the real solar system — fine
  for framework validation, NOT for publication-grade real data.
- ``spk``: binary SPK/DAF kernel reader + Chebyshev evaluation for
  user-supplied JPL DE kernels (de440.bsp etc.) — no kernel ships in this
  zero-egress build (disk verified empty of .bsp).

`get_ephemeris(name)` returns a provider; names "DE440" etc. resolve to a
kernel file if one has been registered/found, else fall back to the
analytic provider with a loud warning.
"""

import os
import warnings

from pint_tpu_torch.ephemeris import kepler as _kepler


class AnalyticEphemeris:
    """Built-in analytic provider (see module docstring for accuracy)."""

    name = "analytic-kepler"

    def ssb_posvel(self, body, tdb_mjd):
        return _kepler.ssb_posvel(body, tdb_mjd)


_REGISTRY = {}


def register_kernel(name, path):
    """Register an SPK kernel file for `name` (e.g. 'DE440')."""
    from pint_tpu_torch.ephemeris.spk import SPKEphemeris

    _REGISTRY[name.upper()] = SPKEphemeris(path)


def get_ephemeris(name=None):
    """Resolve an ephemeris by name ('DE440', ...) or return the default
    analytic provider. Checks $PINT_TPU_EPHEM_DIR for '<name>.bsp'."""
    if name:
        key = str(name).upper()
        if key in _REGISTRY:
            return _REGISTRY[key]
        from pint_tpu_torch import config

        ephem_dir = config.ephem_dir()
        if ephem_dir is not None:
            cand = os.path.join(str(ephem_dir), f"{key.lower()}.bsp")
            if os.path.exists(cand):
                register_kernel(key, cand)
                return _REGISTRY[key]
        warnings.warn(
            f"No SPK kernel available for ephemeris {name!r} (zero-egress "
            "build, no .bsp on disk); falling back to the built-in "
            "analytic Kepler ephemeris — internally consistent but only "
            "~arcmin-level absolute accuracy. Set $PINT_TPU_EPHEM_DIR or "
            "call register_kernel() for real-data work.",
            stacklevel=2,
        )
    return AnalyticEphemeris()
