"""Binary-model parameterization conversion (a port of
pint_tpu/binaryconvert.py: host parameter algebra over the port's binary
registry; the new model is on the old one's device).

Reference: src/pint/binaryconvert.py (convert_binary). Supported
conversions mirror the reference's core set:

    ELL1  <-> DD / DDS / DDH / BT      (EPS1/EPS2/TASC <-> ECC/OM/T0)
    ELL1  <-> ELL1H                    (M2/SINI <-> H3/STIG)
    DD    <-> DDS                      (SINI <-> SHAPMAX)
    DD    <-> DDH                      (M2/SINI <-> H3/STIG)

The converted model is a new TimingModel sharing every non-binary
component; uncertainties are propagated to first order where the map
is nonlinear (ECC/OM from EPS1/EPS2).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.models.timing_model import TimingModel, copy_model

__all__ = ["convert_binary"]

TSUN = 4.925490947e-6
SECS_PER_DAY = 86400.0


def _binary_component(model: TimingModel):
    for name, comp in model.components.items():
        if name.startswith("Binary"):
            return name, comp
    raise ValueError("model has no binary component")


def _get(comp, name, default=None):
    p = comp.params.get(name)
    return p.value if p is not None and p.value is not None else default


def _mean_motion(comp):
    """Orbital angular frequency [rad/day] from PB or FB0."""
    pb = _get(comp, "PB")
    if pb is not None:
        return 2.0 * np.pi / pb
    fb0 = _get(comp, "FB0")
    if fb0 is None:
        raise ValueError("binary model has neither PB nor FB0")
    return 2.0 * np.pi * fb0 * SECS_PER_DAY


def _h3stig_from_m2sini(m2, sini):
    cosi = np.sqrt(1.0 - sini ** 2)
    stig = sini / (1.0 + cosi)
    h3 = TSUN * m2 * stig ** 3
    return h3, stig


def _m2sini_from_h3stig(h3, stig):
    sini = 2.0 * stig / (1.0 + stig ** 2)
    m2 = h3 / (TSUN * stig ** 3)
    return m2, sini


def convert_binary(model: TimingModel, target: str) -> TimingModel:
    """Return a copy of ``model`` with its binary component converted
    to the ``target`` parameterization (reference:
    binaryconvert.convert_binary)."""
    from pint_tpu_torch.models.timing_model import component_types

    by_upper = {c[len("Binary"):].upper(): c for c in component_types
                if c.startswith("Binary")}
    cls_name = by_upper.get(target.upper())
    if cls_name is None:
        raise ValueError(f"unknown binary model {target!r}")
    src_name, src = _binary_component(model)
    if src_name == cls_name:
        return copy_model(model)
    if src_name == "BinaryDDGR":
        raise ValueError(
            "cannot convert from DDGR: its post-Keplerian parameters "
            "are mass-derived, not explicit — evaluate them and build "
            "a DD model directly if needed")

    new = copy_model(model)
    new.remove_component(src_name)
    dst = component_types[cls_name]()
    new.add_component(dst, setup=False)

    # ---- shared Keplerian/secular/Shapiro params pass through -------
    for name in ("PB", "PBDOT", "A1", "A1DOT", "M2", "SINI", "GAMMA",
                 "ECC", "EDOT", "OM", "OMDOT", "T0", "TASC", "EPS1",
                 "EPS2", "EPS1DOT", "EPS2DOT", "H3", "H4", "STIG",
                 "SHAPMAX", "DR", "DTH", "A0", "B0", "KIN", "KOM",
                 "MTOT", "XOMDOT", "XPBDOT", "LNEDOT"):
        if name in src.params and name in dst.params:
            sp = src.params[name]
            dp = dst.params[name]
            dp.value = sp.value
            dp.frozen = sp.frozen
            dp.uncertainty = sp.uncertainty
            if sp._dd is not None:
                dp.set_dd(sp._dd)
    # FB series passes through when both sides support it
    for name in getattr(src, "fb_terms", []):
        if name in src.params:
            sp = src.params[name]
            dst.add_fb_term(int(name[2:]), value=sp.value,
                            frozen=sp.frozen)

    src_is_ell1 = "EPS1" in src.params
    dst_is_ell1 = "EPS1" in dst.params

    RAD_PER_S_TO_DEG_PER_YR = np.degrees(1.0) * 86400.0 * 365.25

    if src_is_ell1 and not dst_is_ell1:
        # ELL1 -> eccentric: ECC/OM/T0 from EPS1/EPS2/TASC
        eps1 = _get(src, "EPS1", 0.0)
        eps2 = _get(src, "EPS2", 0.0)
        ecc = float(np.hypot(eps1, eps2))
        om = float(np.arctan2(eps1, eps2)) % (2.0 * np.pi)
        nb = _mean_motion(src)  # rad/day
        tasc = _get(src, "TASC")
        dst.params["ECC"].value = ecc
        dst.params["OM"].value = np.degrees(om)
        dst.params["T0"].value = tasc + om / nb
        # secular drifts: eps1 = e sin w, eps2 = e cos w =>
        # edot = (eps1 d1 + eps2 d2)/e, wdot = (d1 eps2 - d2 eps1)/e^2
        d1 = _get(src, "EPS1DOT", 0.0)
        d2 = _get(src, "EPS2DOT", 0.0)
        if (d1 or d2) and ecc > 0:
            if "EDOT" in dst.params:
                dst.params["EDOT"].value = (eps1 * d1 + eps2 * d2) / ecc
            if "OMDOT" in dst.params:
                dst.params["OMDOT"].value = float(
                    (d1 * eps2 - d2 * eps1) / ecc ** 2
                    * RAD_PER_S_TO_DEG_PER_YR)
        # first-order uncertainty propagation
        s1 = src.params["EPS1"].uncertainty
        s2 = src.params["EPS2"].uncertainty
        if s1 is not None and s2 is not None and ecc > 0:
            decc = np.hypot(eps1 * s1, eps2 * s2) / ecc
            dom = np.hypot(eps2 * s1, eps1 * s2) / ecc ** 2
            dst.params["ECC"].uncertainty = float(decc)
            dst.params["OM"].uncertainty = float(np.degrees(dom))
            dst.params["T0"].uncertainty = float(dom / nb)
        for nm in ("ECC", "OM", "T0"):
            dst.params[nm].frozen = src.params["EPS1"].frozen
    elif dst_is_ell1 and not src_is_ell1:
        # eccentric -> ELL1 (valid for small e)
        ecc = _get(src, "ECC", 0.0)
        om = np.radians(_get(src, "OM", 0.0))
        t0 = _get(src, "T0")
        nb = _mean_motion(src)
        if ecc > 0.01:
            import warnings

            warnings.warn(f"ELL1 conversion at e={ecc:.3g} > 0.01: "
                          "O(e^2) timing errors may be significant")
        dst.params["EPS1"].value = float(ecc * np.sin(om))
        dst.params["EPS2"].value = float(ecc * np.cos(om))
        dst.params["TASC"].value = t0 - om / nb
        edot = _get(src, "EDOT", 0.0)
        omdot = _get(src, "OMDOT", 0.0) / RAD_PER_S_TO_DEG_PER_YR
        if (edot or omdot):
            d1 = edot * np.sin(om) + ecc * np.cos(om) * omdot
            d2 = edot * np.cos(om) - ecc * np.sin(om) * omdot
            if "EPS1DOT" in dst.params:
                dst.params["EPS1DOT"].value = float(d1)
                dst.params["EPS2DOT"].value = float(d2)
            elif "LNEDOT" in dst.params and ecc > 0:
                # ELL1k: exact rotation + log-eccentricity rate
                dst.params["OMDOT"].value = _get(src, "OMDOT", 0.0)
                dst.params["LNEDOT"].value = float(edot / ecc)
        se = src.params["ECC"].uncertainty
        so = src.params["OM"].uncertainty
        if se is not None and so is not None:
            so_r = np.radians(so)
            dst.params["EPS1"].uncertainty = float(np.hypot(
                np.sin(om) * se, ecc * np.cos(om) * so_r))
            dst.params["EPS2"].uncertainty = float(np.hypot(
                np.cos(om) * se, ecc * np.sin(om) * so_r))
            dst.params["TASC"].uncertainty = float(so_r / nb)
        for nm in ("EPS1", "EPS2", "TASC"):
            dst.params[nm].frozen = src.params["ECC"].frozen

    if src_is_ell1 and dst_is_ell1:
        # within the ELL1 family: map linear eps drifts <-> ELL1k's
        # exact (OMDOT, LNEDOT) rotation parameters
        eps1 = _get(src, "EPS1", 0.0)
        eps2 = _get(src, "EPS2", 0.0)
        ecc2 = eps1 ** 2 + eps2 ** 2
        d1 = _get(src, "EPS1DOT", 0.0)
        d2 = _get(src, "EPS2DOT", 0.0)
        if (d1 or d2) and ecc2 > 0 and "LNEDOT" in dst.params:
            dst.params["OMDOT"].value = float(
                (d1 * eps2 - d2 * eps1) / ecc2
                * RAD_PER_S_TO_DEG_PER_YR)
            dst.params["LNEDOT"].value = float(
                (eps1 * d1 + eps2 * d2) / ecc2)
        if "LNEDOT" in src.params and "EPS1DOT" in dst.params:
            omdot = _get(src, "OMDOT", 0.0) / RAD_PER_S_TO_DEG_PER_YR
            lnedot = _get(src, "LNEDOT", 0.0)
            if omdot or lnedot:
                dst.params["EPS1DOT"].value = float(
                    lnedot * eps1 + eps2 * omdot)
                dst.params["EPS2DOT"].value = float(
                    lnedot * eps2 - eps1 * omdot)

    # ---- Shapiro reparameterizations --------------------------------
    if "H3" in dst.params and "H3" not in src.params:
        m2, sini = _get(src, "M2"), _get(src, "SINI")
        if "SHAPMAX" in src.params and _get(src, "SHAPMAX") is not None:
            sini = 1.0 - np.exp(-_get(src, "SHAPMAX"))
        if m2 is not None and sini is not None:
            h3, stig = _h3stig_from_m2sini(m2, sini)
            dst.params["H3"].value = float(h3)
            dst.params["STIG"].value = float(stig)
            dst.params["H3"].frozen = src.params["M2"].frozen
            dst.params["STIG"].frozen = src.params["M2"].frozen
    if "M2" in dst.params and "M2" not in src.params:
        h3, stig = _get(src, "H3"), _get(src, "STIG")
        if stig is None and h3 and _get(src, "H4") is not None:
            # orthometric ratio: STIG = H4/H3 (Freire & Wex 2010)
            stig = _get(src, "H4") / h3
        if h3 is not None and stig is not None:
            m2, sini = _m2sini_from_h3stig(h3, stig)
            dst.params["M2"].value = float(m2)
            if "SINI" in dst.params:
                dst.params["SINI"].value = float(sini)
                dst.params["SINI"].frozen = src.params["H3"].frozen
            elif "SHAPMAX" in dst.params:
                dst.params["SHAPMAX"].value = float(-np.log(1.0 - sini))
                dst.params["SHAPMAX"].frozen = src.params["H3"].frozen
            dst.params["M2"].frozen = src.params["H3"].frozen
    if "SINI" in dst.params and _get(dst, "SINI") is None and \
            "KIN" in src.params and _get(src, "KIN") is not None:
        dst.params["SINI"].value = float(np.sin(np.radians(
            _get(src, "KIN"))))
        dst.params["SINI"].frozen = src.params["KIN"].frozen
    if "SHAPMAX" in dst.params and "SINI" in src.params and \
            _get(src, "SINI") is not None:
        dst.params["SHAPMAX"].value = float(
            -np.log(1.0 - _get(src, "SINI")))
        dst.params["SHAPMAX"].frozen = src.params["SINI"].frozen
    if "SINI" in dst.params and "SHAPMAX" in src.params and \
            _get(src, "SHAPMAX") is not None:
        dst.params["SINI"].value = float(
            1.0 - np.exp(-_get(src, "SHAPMAX")))
        dst.params["SINI"].frozen = src.params["SHAPMAX"].frozen

    dst.setup()
    dst.validate()
    new.invalidate_cache()
    return new
