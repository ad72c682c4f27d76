"""TCB <-> TDB par-file conversion (a port of
pint_tpu/models/tcb_conversion.py: host dd parameter algebra; the new
model is on the old one's device).

Reference: src/pint/models/tcb_conversion.py (convert_tcb_tdb) +
scripts/tcb2tdb.py. TCB ticks faster than TDB by the IAU 1991/2006
defining constant L_B; the conversion rescales every dimensionful
parameter by the appropriate power of IFTE_K = 1/(1 - L_B) and maps
epochs through the fixed point T0 (MJD 43144.0003725, the 1977 TAI
origin where TCB = TDB):

    (t_TDB - T0) = (t_TCB - T0) / IFTE_K
    value_TDB    = value_TCB * IFTE_K^n

with n the parameter's effective time dimension (frequency-like: +1
per 1/s; interval-like: -1; see _TIME_DIM). This is the linear-drift
part of the transformation only — exactly what the reference applies —
so converted models are equivalent to ~L_B * (periodic TDB-TCB terms),
well below timing noise.
"""

from __future__ import annotations

import re
import warnings

from pint_tpu_torch.models.timing_model import copy_model
from pint_tpu_torch.ops import dd_np

__all__ = ["convert_tcb_tdb", "IFTE_K", "L_B", "T0_MJD"]

L_B = 1.550519768e-8  # IAU 2006 defining constant
IFTE_K = 1.0 / (1.0 - L_B)
T0_MJD = 43144.0003725  # TCB = TDB fixed point

# effective time dimension n: value_TDB = value_TCB * IFTE_K^n
_TIME_DIM = {
    "DM": -1,           # measured dispersion delay is an interval
    "NE_SW": -1,
    "CM": -1,
    "PX": 1,            # ~1/distance, distance in light-time
    "PMRA": 1, "PMDEC": 1, "PMELONG": 1, "PMELAT": 1,  # per time
    "PB": -1,
    "A1": -1,
    "GAMMA": -1,
    "M2": -1,           # masses enter as G m / c^3 [s]
    "MTOT": -1,
    "H3": -1,
    "OMDOT": 1,
    "EDOT": 1,
    "EPS1DOT": 1,
    "EPS2DOT": 1,
    "LNEDOT": 1,
    "WAVE_OM": 1,
    # dimensionless / angle / ratio parameters (listed so the
    # completeness check below knows they are intentionally unscaled)
    "OM": 0, "ECC": 0, "SINI": 0, "EPS1": 0, "EPS2": 0, "A1DOT": 0,
    "PBDOT": 0, "XPBDOT": 0, "STIG": 0, "KIN": 0, "KOM": 0,
    "XOMDOT": 1, "SHAPMAX": 0, "DR": 0, "DTH": 0, "A0": -1, "B0": -1,
    "EFAC": 0, "DMEFAC": 0, "TNCHROMIDX": 0, "SWM": 0,
    "RAJ": 0, "DECJ": 0, "ELONG": 0, "ELAT": 0,  # angles
    "TZRFRQ": 0,  # observing frequency: a label, not a TCB interval
}
_EPOCH_NAMES = ("PEPOCH", "POSEPOCH", "DMEPOCH", "CMEPOCH", "T0",
                "TASC", "TZRMJD", "WXEPOCH", "DMWXEPOCH", "CMWXEPOCH",
                "START", "FINISH")
# prefixed families: (regex, time dimension or callable(index) or
# "epoch")
_PREFIX_DIMS = [
    (re.compile(r"^F(\d+)$"), lambda n: n + 1),
    (re.compile(r"^DM(\d+)$"), lambda n: n - 1),
    (re.compile(r"^CM(\d+)$"), lambda n: n - 1),
    (re.compile(r"^FB(\d+)$"), lambda n: n + 1),
    (re.compile(r"^(GLEP_|DMXR1_|DMXR2_|CMXR1_|CMXR2_|PWEP_|PWSTART_"
                r"|PWSTOP_|SWXR1_|SWXR2_)\d+$"), "epoch"),
    (re.compile(r"^GLF0_\d+$"), 1),
    (re.compile(r"^GLF1_\d+$"), 2),
    (re.compile(r"^GLF2_\d+$"), 3),
    (re.compile(r"^GLF0D_\d+$"), 1),
    (re.compile(r"^GLTD_\d+$"), -1),
    (re.compile(r"^GLPH_\d+$"), 0),
    (re.compile(r"^PWF0_\d+$"), 1),
    (re.compile(r"^PWF1_\d+$"), 2),
    (re.compile(r"^PWF2_\d+$"), 3),
    (re.compile(r"^PWPH_\d+$"), 0),
    (re.compile(r"^DMX_\d+$"), -1),
    (re.compile(r"^CMX_\d+$"), -1),
    (re.compile(r"^SWXDM_\d+$"), -1),
    (re.compile(r"^(WX|DMWX|CMWX)FREQ_\d+$"), 1),
    (re.compile(r"^WX(SIN|COS)_\d+$"), -1),
    (re.compile(r"^DMWX(SIN|COS)_\d+$"), -1),
    (re.compile(r"^CMWX(SIN|COS)_\d+$"), -1),
    (re.compile(r"^FD\d+$"), -1),
    (re.compile(r"^FD\d*JUMP\d+$"), -1),
    (re.compile(r"^FDJUMP\d+$"), -1),
    (re.compile(r"^JUMP\d+$"), -1),
    (re.compile(r"^DMJUMP\d+$"), -1),
    (re.compile(r"^(EQUAD|ECORR)\d+$"), -1),
    (re.compile(r"^(EFAC|DMEFAC|TNEQ|DMEQUAD)\d+$"), 0),
    (re.compile(r"^WAVE\d+$"), -1),
]


def _time_dim(name: str):
    """Time dimension n, the string 'epoch', or None (unclassified)."""
    if name in _EPOCH_NAMES:
        return "epoch"
    if name in _TIME_DIM:
        return _TIME_DIM[name]
    for rx, dim in _PREFIX_DIMS:
        m = rx.match(name)
        if m:
            if dim == "epoch":
                return "epoch"
            return dim(int(m.group(1))) if callable(dim) else dim
    return None


def _map_epoch_dd(p, K_dd_inv):
    """mjd -> T0 + (mjd - T0) * K_dd_inv in dd arithmetic (keeps the
    sub-f64 epoch residue MJDParameter maintains)."""
    t0 = dd_np.dd(T0_MJD)
    x = dd_np.sub(p.dd, t0)
    x = dd_np.mul(x, K_dd_inv)
    new = dd_np.add(x, t0)
    p.set_dd((float(new[0]), float(new[1])))


def convert_tcb_tdb(model, backwards: bool = False):
    """Return a copy of ``model`` converted TCB->TDB (or TDB->TCB with
    ``backwards``); reference: tcb_conversion.convert_tcb_tdb. Every
    dimensionful parameter — including prefix/mask family members —
    is scaled; unclassified dimensionful-looking parameters trigger a
    warning rather than silent half-conversion."""
    units = (model.UNITS.value or "TDB").upper()
    src, dst = ("TDB", "TCB") if backwards else ("TCB", "TDB")
    if units != src:
        raise ValueError(f"model UNITS is {units}, expected {src}")
    K = 1.0 / IFTE_K if backwards else IFTE_K
    # exact dd factors: (1 - L_B) is exactly 1 + (-L_B) in dd
    one_minus = dd_np.add_f(dd_np.dd(1.0), -L_B)
    inv_one_minus = dd_np.div(dd_np.dd(1.0), one_minus)
    # K_dd multiplies values of positive time dimension; K_dd_inv maps
    # epochs/intervals (forward: intervals shrink by (1-L_B))
    if backwards:
        K_dd, K_dd_inv = one_minus, inv_one_minus
    else:
        K_dd, K_dd_inv = inv_one_minus, one_minus
    new = copy_model(model)
    unclassified = []
    for comp in new.components.values():
        for name, p in comp.params.items():
            if p.value is None or isinstance(p.value, bool) or \
                    not isinstance(p.value, (int, float)):
                continue
            n = _time_dim(name)
            if n == "epoch":
                _map_epoch_dd(p, K_dd_inv)
                continue
            if n is None:
                unclassified.append(name)
                continue
            if n:
                # scale in dd so long-precision values (F0 given to 20
                # digits) keep their sub-ulp residue
                f = K_dd_inv if n < 0 else K_dd
                scaled = p.dd
                for _ in range(abs(n)):
                    scaled = dd_np.mul(scaled, f)
                p.set_dd((float(scaled[0]), float(scaled[1])))
                if p.uncertainty is not None:
                    p.uncertainty = p.uncertainty * K ** n
    if unclassified:
        skipped = [nm for nm in unclassified
                   if nm not in ("NTOA", "CHI2", "SIFUNC")]
        if skipped:
            warnings.warn(
                "TCB conversion left these parameters unscaled "
                f"(unknown time dimension): {sorted(set(skipped))}")
    new.UNITS.value = dst
    new.invalidate_cache()
    return new
