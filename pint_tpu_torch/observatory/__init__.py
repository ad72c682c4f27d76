"""Observatory registry: name/alias → Observatory singleton.

Reference: src/pint/observatory/__init__.py (Observatory,
get_observatory), topo_obs.py (TopoObs), special_locations.py
(BarycenterObs, GeocenterObs). Ground stations carry ITRF coordinates
and a clock chain; special locations override positions/timescale.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.observatory.clock import find_clock_file
from pint_tpu_torch.observatory.sites import load_sites
from pint_tpu_torch.time import frames


class Observatory:
    """Base observatory. Subclasses define how to get the observatory
    position/velocity wrt the geocenter in GCRS, the clock chain, and the
    native timescale of TOAs recorded there."""

    timescale = "utc"

    def __init__(self, name, aliases=()):
        self.name = name
        self.aliases = tuple(aliases)

    def clock_corrections(self, utc_mjd, include_gps=True, include_bipm=True,
                          bipm_version="BIPM2021", limits="warn"):
        """Total clock correction [seconds] to add to raw TOA MJDs."""
        return np.zeros_like(np.asarray(utc_mjd, np.float64))

    def gcrs_posvel(self, utc_mjd, tt_mjd):
        """Observatory position [m] / velocity [m/s] wrt geocenter, GCRS."""
        z = np.zeros((np.atleast_1d(utc_mjd).shape[0], 3))
        return z, z.copy()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class TopoObs(Observatory):
    """Ground station with ITRF coordinates (reference: TopoObs)."""

    def __init__(self, name, itrf_xyz_m, aliases=(), tempo_code=None,
                 clock_file=None, clock_fmt="tempo2"):
        super().__init__(name, aliases)
        self.itrf_xyz_m = np.asarray(itrf_xyz_m, np.float64)
        self.tempo_code = tempo_code
        self._clock_file_name = clock_file or f"{name}2gps.clk"
        self._clock_fmt = clock_fmt
        self._clock = None

    def _get_clock(self):
        if self._clock is None:
            self._clock = find_clock_file(self._clock_file_name,
                                          fmt=self._clock_fmt)
        return self._clock

    def clock_corrections(self, utc_mjd, include_gps=True, include_bipm=True,
                          bipm_version="BIPM2021", limits="warn"):
        """site→GPS (per-site file) + GPS→UTC + optional UTC(TAI)→TT(BIPM)
        minus TT(TAI); all files zero-fallback offline."""
        utc_mjd = np.asarray(utc_mjd, np.float64)
        corr = self._get_clock().evaluate(utc_mjd, limits=limits)
        if include_gps:
            corr = corr + find_clock_file("gps2utc.clk").evaluate(
                utc_mjd, limits=limits)
        if include_bipm:
            fname = f"tai2tt_{bipm_version.lower()}.clk"
            corr = corr + find_clock_file(fname).evaluate(utc_mjd,
                                                          limits=limits)
        return corr

    def gcrs_posvel(self, utc_mjd, tt_mjd):
        return frames.itrf_to_gcrs_posvel(self.itrf_xyz_m, utc_mjd, tt_mjd)


class BarycenterObs(Observatory):
    """TOAs already at the SSB, in TDB (tempo2 'bat' style;
    reference: special_locations.py BarycenterObs)."""

    timescale = "tdb"

    def __init__(self):
        super().__init__("barycenter", aliases=("@", "ssb", "bat"))


class GeocenterObs(Observatory):
    """TOAs at the geocenter, UTC (reference: GeocenterObs)."""

    def __init__(self):
        super().__init__("geocenter", aliases=("0", "geo", "coe"))


_registry: "dict[str, Observatory]" = {}
_alias_map: "dict[str, str]" = {}
_builtins_loaded = False


def register_observatory(obs: Observatory, overwrite=False):
    key = obs.name.lower()
    if key in _registry and not overwrite:
        raise ValueError(f"observatory {obs.name!r} already registered")
    _registry[key] = obs
    _alias_map[key] = key
    for a in obs.aliases:
        _alias_map[a.lower()] = key
    if getattr(obs, "tempo_code", None):
        _alias_map[obs.tempo_code.lower()] = key


def _ensure_builtins():
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    for name, entry in load_sites().items():
        if name.lower() in _registry:  # user pre-registered an override
            continue
        register_observatory(
            TopoObs(name, entry["itrf"], aliases=entry.get("aliases", ()),
                    tempo_code=entry.get("tempo_code")))
    register_observatory(BarycenterObs())
    register_observatory(GeocenterObs())
    from pint_tpu_torch.observatory.satellite_obs import T2SpacecraftObs

    register_observatory(T2SpacecraftObs())


def get_observatory(name: str) -> Observatory:
    """Resolve an observatory by canonical name, alias, or tempo code
    (case-insensitive) — reference: get_observatory()."""
    _ensure_builtins()
    key = _alias_map.get(str(name).lower())
    if key is None:
        raise KeyError(
            f"unknown observatory {name!r}; known: "
            f"{sorted(_registry)} (+aliases)")
    return _registry[key]


def list_observatories():
    _ensure_builtins()
    return sorted(_registry)
