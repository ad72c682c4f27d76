"""Satellite observatories: spacecraft orbit files -> per-photon
observatory positions.

Reference: src/pint/observatory/satellite_obs.py
(get_satellite_observatory, SatelliteObs over FT2/orbit FITS) and
special_locations.py (T2SpacecraftObs). The orbit FITS carries the
spacecraft position versus mission time; photon TOAs then use the
interpolated position as their "observatory" so the barycentering
chain (Roemer/parallax/Shapiro) works exactly as for ground sites.

Conventions handled:
- position columns POS_X/POS_Y/POS_Z (NICER/RXTE/Swift/NuSTAR MKF,
  meters or km) or SC_POSITION (Fermi FT2, meters, (N,3) vector col);
- TIME in mission seconds from the header MJDREF, assumed TT;
- positions are J2000/GCRS-aligned Earth-centered inertial (the
  mission standard), so no Earth-rotation transform is applied.

T2SpacecraftObs instead takes the position per TOA from -telx/-tely/
-telz flags (light-seconds, tempo2 convention).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pint_tpu_torch.observatory import Observatory, register_observatory

__all__ = ["SatelliteObs", "get_satellite_observatory",
           "T2SpacecraftObs"]

C_M_S = 299792458.0


class SatelliteObs(Observatory):
    """Orbiting observatory with positions interpolated from an orbit
    FITS file (reference: satellite_obs.SatelliteObs)."""

    timescale = "utc"  # photon TIME columns are TT; TOA loaders handle

    def __init__(self, name, orbit_file, aliases=()):
        super().__init__(name, aliases)
        from pint_tpu_torch.io.fits import read_fits

        hdus = read_fits(orbit_file)
        tables = [h for h in hdus if h.data]
        if not tables:
            raise ValueError(f"no binary table in orbit file "
                             f"{orbit_file!r}")
        tab = next((h for h in tables
                    if h.name.upper() in ("SC_DATA", "ORBIT", "PREFILTER")),
                   tables[0])
        cols = {k.upper(): v for k, v in tab.data.items()}
        hdr = tab.header
        mjdrefi = float(hdr.get("MJDREFI", 0.0))
        mjdreff = float(hdr.get("MJDREFF", 0.0))
        if mjdrefi == 0.0 and "MJDREF" in hdr:
            v = float(hdr["MJDREF"])
            mjdrefi, mjdreff = np.floor(v), v - np.floor(v)
        t = np.asarray(cols["TIME"], dtype=np.float64)
        if "SC_POSITION" in cols:  # Fermi FT2: (N,3) meters
            pos = np.asarray(cols["SC_POSITION"], dtype=np.float64)
        else:
            try:
                pos = np.stack([np.asarray(cols[f"POS_{ax}"],
                                           dtype=np.float64)
                                for ax in "XYZ"], axis=-1)
            except KeyError:
                raise ValueError(
                    "orbit file needs SC_POSITION or POS_X/Y/Z "
                    f"columns; found {sorted(cols)}")
        # km-vs-m heuristic: LEO radius is ~6.8e6 m / ~6.8e3 km
        if np.median(np.linalg.norm(pos, axis=-1)) < 1e5:
            pos = pos * 1e3
        order = np.argsort(t)
        self._t_mjd = mjdrefi + (t[order] / 86400.0 + mjdreff)
        self._pos_m = pos[order]
        self.mjdref = (mjdrefi, mjdreff)

    def gcrs_posvel(self, utc_mjd, tt_mjd):
        """Interpolated ECI position [m] and finite-difference velocity
        [m/s] at the given epochs (orbit files are sampled at ~1-30 s:
        linear interpolation is ~m-accurate for LEO)."""
        tq = np.atleast_1d(np.asarray(tt_mjd, np.float64))
        if tq.min() < self._t_mjd[0] - 1e-6 or \
                tq.max() > self._t_mjd[-1] + 1e-6:
            raise ValueError(
                f"epochs [{tq.min():.6f}, {tq.max():.6f}] outside the "
                f"orbit file span [{self._t_mjd[0]:.6f}, "
                f"{self._t_mjd[-1]:.6f}]")
        pos = np.stack([np.interp(tq, self._t_mjd, self._pos_m[:, k])
                        for k in range(3)], axis=-1)
        dt = 1.0 / 86400.0  # 1 s
        # clamp the stencil inside the table (np.interp would silently
        # hold the endpoint value, halving the velocity near the edges)
        # and divide by the time actually spanned
        tp = np.minimum(tq + dt, self._t_mjd[-1])
        tm = np.maximum(tq - dt, self._t_mjd[0])
        pos_p = np.stack([np.interp(tp, self._t_mjd,
                                    self._pos_m[:, k])
                          for k in range(3)], axis=-1)
        pos_m_ = np.stack([np.interp(tm, self._t_mjd,
                                     self._pos_m[:, k])
                           for k in range(3)], axis=-1)
        span_s = (tp - tm) * 86400.0
        vel = (pos_p - pos_m_) / span_s[:, None]
        return pos, vel


def get_satellite_observatory(name, orbit_file, overwrite=True
                              ) -> SatelliteObs:
    """Load an orbit file and register the mission as an observatory
    (reference: satellite_obs.get_satellite_observatory)."""
    obs = SatelliteObs(name.lower(), orbit_file)
    register_observatory(obs, overwrite=overwrite)
    return obs


class T2SpacecraftObs(Observatory):
    """Spacecraft positions supplied per TOA via -telx/-tely/-telz
    flags in light-seconds (tempo2 convention; reference:
    special_locations.T2SpacecraftObs). The TOA pipeline calls
    posvel_from_flags with the TOA flag dicts."""

    def __init__(self):
        super().__init__("stl_geo", aliases=("spacecraft", "stl"))

    def posvel_from_flags(self, flags):
        """((N,3) positions [m], (N,3) velocities [m/s]) from per-TOA
        flags: -telx/-tely/-telz [lt-s] mandatory, -telvx/-telvy/-telvz
        [lt-s/s] optional (zero velocity without them — the barycentric
        Doppler frequency then omits the spacecraft motion)."""
        pos = np.zeros((len(flags), 3))
        vel = np.zeros((len(flags), 3))
        for i, f in enumerate(flags):
            try:
                pos[i] = [float(f["telx"]) * C_M_S,
                          float(f["tely"]) * C_M_S,
                          float(f["telz"]) * C_M_S]
            except KeyError as e:
                raise ValueError(
                    f"TOA {i} at spacecraft site lacks -{e.args[0]} "
                    "flag") from e
            if "telvx" in f:
                vel[i] = [float(f["telvx"]) * C_M_S,
                          float(f.get("telvy", 0.0)) * C_M_S,
                          float(f.get("telvz", 0.0)) * C_M_S]
        return pos, vel
