"""Photon-event ingestion: mission FITS event tables -> TOAs (a port of
pint_tpu/event_toas.py; reference: src/pint/event_toas.py load_fits_TOAs,
per-mission wrappers, and src/pint/fermi_toas.py photon weights).

Event TIME columns count seconds from the mission MJDREF (MJDREFI +
MJDREFF) in the header's TIMESYS. Barycentred event files (TIMESYS=TDB,
TIMEREF=SOLARSYSTEM) map directly onto '@' (barycenter) TOAs.
Un-barycentred TT files need the spacecraft orbit; loading them without
one raises rather than silently mis-assigning phases.

Photon weights are held as a float64 column, ``TOAs.weights``, with the
values the reference's ``-weight`` flag strings give: each weight rounded
to 8 significant digits.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from pint_tpu_torch.io.fits import read_events_fits
from pint_tpu_torch.ops import dd_np
from pint_tpu_torch.toa import TOAs, get_TOAs_array

__all__ = ["load_fits_TOAs", "load_event_TOAs", "load_Fermi_TOAs",
           "load_NICER_TOAs", "load_RXTE_TOAs", "load_NuSTAR_TOAs",
           "load_Swift_TOAs", "load_XMM_TOAs", "get_event_weights",
           "get_fits_TOAs", "get_event_TOAs", "get_Fermi_TOAs",
           "get_NICER_TOAs", "get_RXTE_TOAs", "get_NuSTAR_TOAs",
           "get_Swift_TOAs", "get_XMM_TOAs"]

# (MJDREFI, MJDREFF) fallbacks when the header omits them
MISSION_MJDREF = {
    "fermi": (51910, 7.428703703703703e-4),
    "nicer": (56658, 7.775925925925926e-4),
    "rxte": (49353, 6.965740740740740e-4),
    "nustar": (55197, 7.660185185185185e-4),
    "swift": (51910, 7.428703703703703e-4),
    "xmm": (50814, 0.0),
}


def _mjdref(header, mission: Optional[str]) -> Tuple[float, float]:
    if "MJDREFI" in header:
        return float(header["MJDREFI"]), float(header.get("MJDREFF", 0.0))
    if "MJDREF" in header:
        v = float(header["MJDREF"])
        return float(np.floor(v)), v - np.floor(v)
    if mission and mission.lower() in MISSION_MJDREF:
        return MISSION_MJDREF[mission.lower()]
    raise ValueError("event file lacks MJDREF and mission is unknown")


def quantize_weights(w: np.ndarray) -> np.ndarray:
    """Each weight rounded to 8 significant digits, exactly as the
    reference's ``f"{w:.8g}"`` flag string parses back."""
    return np.array([float(f"{x:.8g}") for x in w.tolist()],
                    dtype=np.float64)


def load_fits_TOAs(eventfile, mission: Optional[str] = None,
                   weightcolumn: Optional[str] = None,
                   minmjd: float = -np.inf, maxmjd: float = np.inf,
                   ephem: Optional[str] = None,
                   planets: bool = False,
                   orbit_file=None, device=None) -> TOAs:
    """Read a FITS event table into TOAs (reference:
    event_toas.load_fits_TOAs). Photon weights go to ``TOAs.weights``.
    ``device`` (None means "cuda") is where the TOAs' batch goes.

    Barycentred files (TIMESYS=TDB) become '@' TOAs directly.
    Un-barycentred TT files need ``orbit_file`` (or a previously
    registered satellite observatory named after ``mission``)."""
    cols, header = read_events_fits(eventfile)
    timesys = str(header.get("TIMESYS", "TT")).strip().upper()
    obs_name = "barycenter"
    if timesys != "TDB":
        from pint_tpu_torch.observatory import get_observatory
        from pint_tpu_torch.observatory.satellite_obs import (
            get_satellite_observatory,
        )

        if orbit_file is not None:
            if mission is None:
                mission = str(header.get("TELESCOP", "sat")).lower()
            get_satellite_observatory(mission, orbit_file)
            obs_name = mission.lower()
        else:
            try:
                if mission is not None:
                    get_observatory(mission.lower())
                    obs_name = mission.lower()
                else:
                    raise KeyError("no mission")
            except KeyError:
                raise NotImplementedError(
                    f"TIMESYS={timesys}: un-barycentered event files "
                    "need a spacecraft orbit file (orbit_file=...)")
    key = next((k for k in cols if k.upper() == "TIME"), None)
    if key is None:
        raise ValueError("event table has no TIME column")
    mjdrefi, mjdreff = _mjdref(header, mission)
    tsec = np.asarray(cols[key], dtype=np.float64)
    tsec = tsec + float(header.get("TIMEZERO", 0.0))
    # split precisely: day from the integer part of sec/86400 relative
    # to MJDREFI; the fractional seconds stay at full f64 resolution
    day_off = np.floor(tsec / 86400.0)
    frac = (tsec - day_off * 86400.0) / 86400.0 + mjdreff
    day = mjdrefi + day_off
    carry = np.floor(frac)
    day, frac = day + carry, frac - carry
    if obs_name != "barycenter":
        # photon TIME is TT; the TOA pipeline expects UTC
        from pint_tpu_torch.time.scales import tt_mjd_to_utc_mjd

        day, frac = tt_mjd_to_utc_mjd(day, frac)
    mjd_float = day + frac
    keep = (mjd_float >= minmjd) & (mjd_float <= maxmjd)
    day, frac = day[keep], frac[keep]

    weights = None
    if weightcolumn is not None:
        wkey = next((k for k in cols if k.upper() ==
                     weightcolumn.upper()), None)
        if wkey is None:
            raise ValueError(f"no weight column {weightcolumn!r}")
        weights = quantize_weights(
            np.asarray(cols[wkey], dtype=np.float64)[keep])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = get_TOAs_array((day, dd_np.dd(frac)), obs=obs_name,
                           freqs=np.inf, errors=0.0,
                           ephem=ephem, planets=planets, device=device)
    t.names = [f"photon{i}" for i in range(t.ntoas)]
    t.weights = weights
    return t


def load_event_TOAs(eventfile, mission: str, **kw) -> TOAs:
    """Mission-dispatching wrapper (reference: load_event_TOAs)."""
    return load_fits_TOAs(eventfile, mission=mission, **kw)


def load_Fermi_TOAs(eventfile, weightcolumn: Optional[str] = None,
                    **kw) -> TOAs:
    """Fermi-LAT FT1 loader; weightcolumn typically 'MODEL_WEIGHT' or a
    column produced by gtsrcprob (reference: fermi_toas.load_Fermi_TOAs)."""
    return load_fits_TOAs(eventfile, mission="fermi",
                          weightcolumn=weightcolumn, **kw)


def load_NICER_TOAs(eventfile, **kw) -> TOAs:
    return load_fits_TOAs(eventfile, mission="nicer", **kw)


def load_RXTE_TOAs(eventfile, **kw) -> TOAs:
    return load_fits_TOAs(eventfile, mission="rxte", **kw)


def load_NuSTAR_TOAs(eventfile, **kw) -> TOAs:
    return load_fits_TOAs(eventfile, mission="nustar", **kw)


def load_Swift_TOAs(eventfile, **kw) -> TOAs:
    return load_fits_TOAs(eventfile, mission="swift", **kw)


def load_XMM_TOAs(eventfile, **kw) -> TOAs:
    return load_fits_TOAs(eventfile, mission="xmm", **kw)


def get_event_weights(toas: TOAs) -> Optional[np.ndarray]:
    """Per-photon weights (the weight column, else -weight flags), or
    None if absent."""
    if toas.weights is not None:
        return toas.weights
    if not any("weight" in f for f in toas.flags):
        return None
    return np.array([float(f.get("weight", 1.0)) for f in toas.flags])


# the reference's modern entry-point names
get_fits_TOAs = load_fits_TOAs
get_event_TOAs = load_event_TOAs
get_Fermi_TOAs = load_Fermi_TOAs
get_NICER_TOAs = load_NICER_TOAs
get_RXTE_TOAs = load_RXTE_TOAs
get_NuSTAR_TOAs = load_NuSTAR_TOAs
get_Swift_TOAs = load_Swift_TOAs
get_XMM_TOAs = load_XMM_TOAs
