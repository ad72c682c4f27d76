"""Model transformation helpers: ecliptic <-> equatorial astrometry
(a port of pint_tpu/modelutils.py, host numpy as there; the new model
is on the old one's device).

Reference: src/pint/modelutils.py (model_equatorial_to_ecliptic,
model_ecliptic_to_equatorial). Positions rotate through the IAU
obliquity matrix; proper motions rotate with the local tangent-plane
Jacobian (position-angle rotation); PX/POSEPOCH carry over.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.models.astrometry import (
    AstrometryEcliptic,
    AstrometryEquatorial,
    icrs_to_ecliptic_matrix,
)
from pint_tpu_torch.models.timing_model import copy_model

__all__ = ["model_ecliptic_to_equatorial",
           "model_equatorial_to_ecliptic"]


def _unit(lon, lat):
    return np.array([np.cos(lat) * np.cos(lon),
                     np.cos(lat) * np.sin(lon), np.sin(lat)])


def _lonlat(v):
    return float(np.arctan2(v[1], v[0]) % (2 * np.pi)), \
        float(np.arcsin(np.clip(v[2], -1, 1)))


def _basis(lon, lat):
    """(east, north) unit vectors at (lon, lat)."""
    e = np.array([-np.sin(lon), np.cos(lon), 0.0])
    n = np.array([-np.sin(lat) * np.cos(lon),
                  -np.sin(lat) * np.sin(lon), np.cos(lat)])
    return e, n


def _convert(model, to_ecliptic: bool, ecl: str = "IERS2010"):
    src_name = "AstrometryEquatorial" if to_ecliptic else \
        "AstrometryEcliptic"
    src = model.components.get(src_name)
    if src is None:
        raise ValueError(f"model has no {src_name}")
    if to_ecliptic:
        obl = AstrometryEcliptic.obliquity_arcsec(ecl)
        M = icrs_to_ecliptic_matrix(obl)  # ecliptic <- ICRS
        lon0, lat0 = src.RAJ.value, src.DECJ.value
        pml, pmb = src.PMRA.value or 0.0, src.PMDEC.value or 0.0
        dst = AstrometryEcliptic()
        dst.ECL.value = ecl
        out_names = ("ELONG", "ELAT", "PMELONG", "PMELAT")
    else:
        M = np.asarray(src._ecl_matrix())  # ICRS <- ecliptic
        lon0, lat0 = src.ELONG.value, src.ELAT.value
        pml, pmb = src.PMELONG.value or 0.0, src.PMELAT.value or 0.0
        dst = AstrometryEquatorial()
        out_names = ("RAJ", "DECJ", "PMRA", "PMDEC")

    v = M @ _unit(lon0, lat0)
    lon1, lat1 = _lonlat(v)
    # rotate the proper-motion vector: express (pm_east, pm_north) in
    # the source basis as a 3-vector, rotate, project on the dest basis
    e0, n0 = _basis(lon0, lat0)
    pm_vec = M @ (pml * e0 + pmb * n0)
    e1, n1 = _basis(lon1, lat1)
    pm_lon, pm_lat = float(pm_vec @ e1), float(pm_vec @ n1)

    new = copy_model(model)
    new.remove_component(src_name)
    new.add_component(dst, setup=False)
    vals = (lon1, lat1, pm_lon, pm_lat)
    for nm, val in zip(out_names, vals):
        dst.params[nm].value = val
    # rotate the on-sky error ellipse (diagonal approximation): the
    # east/north variances mix through the same position-angle rotation
    # as the PM vector; longitude errors carry 1/cos(lat) coordinate
    # factors (east = d(lon) cos(lat))
    in_names = ("RAJ", "DECJ", "PMRA", "PMDEC") if to_ecliptic else \
        ("ELONG", "ELAT", "PMELONG", "PMELAT")
    c_rot = float((M @ e0) @ e1)
    s_rot = float((M @ e0) @ n1)
    sig_lon0 = src.params[in_names[0]].uncertainty
    sig_lat0 = src.params[in_names[1]].uncertainty
    if sig_lon0 is not None and sig_lat0 is not None:
        ve0 = (sig_lon0 * np.cos(lat0)) ** 2
        vn0 = sig_lat0 ** 2
        ve1 = c_rot ** 2 * ve0 + s_rot ** 2 * vn0
        vn1 = s_rot ** 2 * ve0 + c_rot ** 2 * vn0
        dst.params[out_names[0]].uncertainty = float(
            np.sqrt(ve1) / np.cos(lat1))
        dst.params[out_names[1]].uncertainty = float(np.sqrt(vn1))
    spm_lon = src.params[in_names[2]].uncertainty
    spm_lat = src.params[in_names[3]].uncertainty
    if spm_lon is not None and spm_lat is not None:
        # PM components are already on-sky (mu_lon* includes cos lat)
        ve1 = c_rot ** 2 * spm_lon ** 2 + s_rot ** 2 * spm_lat ** 2
        vn1 = s_rot ** 2 * spm_lon ** 2 + c_rot ** 2 * spm_lat ** 2
        dst.params[out_names[2]].uncertainty = float(np.sqrt(ve1))
        dst.params[out_names[3]].uncertainty = float(np.sqrt(vn1))
    for nm_src, nm_dst in zip(in_names, out_names):
        sp = src.params[nm_src]
        dst.params[nm_dst].frozen = sp.frozen
    for shared in ("PX", "POSEPOCH", "PMRV"):
        if shared in src.params and shared in dst.params:
            sp, dp = src.params[shared], dst.params[shared]
            dp.value, dp.frozen = sp.value, sp.frozen
            dp.uncertainty = sp.uncertainty
    dst.setup()
    dst.validate()
    new.invalidate_cache()
    return new


def model_equatorial_to_ecliptic(model, ecl: str = "IERS2010"):
    """RAJ/DECJ model -> ELONG/ELAT model (reference:
    modelutils.model_equatorial_to_ecliptic). ``ecl`` picks the
    obliquity convention (the new model's ECL parameter)."""
    return _convert(model, to_ecliptic=True, ecl=ecl)


def model_ecliptic_to_equatorial(model):
    """ELONG/ELAT model -> RAJ/DECJ model (reference:
    modelutils.model_ecliptic_to_equatorial)."""
    return _convert(model, to_ecliptic=False)
