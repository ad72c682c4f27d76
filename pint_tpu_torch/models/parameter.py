"""Typed timing-model parameters.

Reference: src/pint/models/parameter.py (Parameter and its zoo:
floatParameter, MJDParameter, AngleParameter, strParameter,
boolParameter, intParameter, maskParameter, prefixParameter).

Design change vs the reference: no astropy — each parameter carries a
static unit *tag* (string) and stores its value as a plain float in its
declared unit; angle parameters store radians and parse/format
sexagesimal; MJD and high-precision float parameters additionally keep a
host double-double (hi, lo) pair so values parsed from 19-digit par
strings never lose bits. The device sees only (hi, lo) vectors — unit
discipline is enforced on the host at build time, costing nothing under
jit (SURVEY.md §5 "race detection" note).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from pint_tpu_torch.ops import dd_np

__all__ = [
    "Parameter", "floatParameter", "MJDParameter", "AngleParameter",
    "strParameter", "boolParameter", "intParameter", "maskParameter",
    "prefixParameter", "pairParameter", "funcParameter",
    "split_prefixed_name",
]


_PREFIX_RE = re.compile(r"^([A-Za-z0-9]+_|[A-Za-z]+)(\d+)$")


def split_prefixed_name(name: str) -> Tuple[str, str, int]:
    """'F12' → ('F', '12', 12); 'DMX_0001' → ('DMX_', '0001', 1)
    (reference: src/pint/utils.py split_prefixed_name)."""
    m = _PREFIX_RE.match(name)
    if not m:
        raise ValueError(f"{name!r} is not a prefixed parameter name")
    return m.group(1), m.group(2), int(m.group(2))


def parse_float_dd(s: str):
    """Parse a decimal-string float into a host dd pair, exactly.

    Splits mantissa digits into two 16-digit legs so e.g.
    '61.485476554373152396' keeps all bits (f64 alone drops ~5 digits).
    """
    s = s.strip().lower().replace("d", "e")
    m = re.match(r"^([+-]?)(\d*)\.?(\d*)(?:e([+-]?\d+))?$", s)
    if not m or not (m.group(2) or m.group(3)):
        raise ValueError(f"bad float literal {s!r}")
    sign = -1.0 if m.group(1) == "-" else 1.0
    ip, fp = m.group(2) or "", m.group(3) or ""
    exp = int(m.group(4) or 0) - len(fp)
    digits = (ip + fp).lstrip("0") or "0"
    # value = digits * 10^exp, accumulated in 16-digit legs (three legs
    # cover 48 significant digits — beyond dd's ~32 — so formatted dd
    # values round-trip bit-exactly including the hi+lo f64 rounding)
    val = dd_np.dd(0.0)
    pos = 0
    for leg in range(3):
        chunk = digits[pos:pos + 16]
        if not chunk:
            break
        val = dd_np.add(
            val,
            dd_np.mul(dd_np.dd(float(int(chunk))),
                      _pow10_dd(exp + len(digits) - pos - len(chunk))))
        pos += 16
    return (sign * val[0], sign * val[1])


def _pow10_dd(n: int):
    """10^n as a dd pair (exact for |n| <= 22, accurate beyond)."""
    if 0 <= n <= 22:
        return dd_np.dd(10.0 ** n)
    if -22 <= n < 0:
        return dd_np.div(dd_np.dd(1.0), dd_np.dd(10.0 ** (-n)))
    half = n // 2
    return dd_np.mul(_pow10_dd(half), _pow10_dd(n - half))


class Parameter:
    """Base parameter: name, unit tag, value, frozen flag, uncertainty."""

    par_dtype = float

    def __init__(self, name: str, value=None, units: str = "",
                 description: str = "", frozen: bool = True,
                 aliases: Optional[List[str]] = None, uncertainty=None,
                 **kw):
        self.name = name
        self.units = units
        self.description = description
        self.frozen = frozen
        self.aliases = list(aliases or [])
        self.uncertainty = uncertainty
        self.prior = None  # None == improper flat (see prior_logpdf)
        self._dd = None
        self.value = value

    # -- Bayesian hooks ------------------------------------------------
    # (reference: Parameter.prior_pdf in src/pint/models/parameter.py)

    def prior_logpdf(self, x=None):
        """log prior density at x (default: the current value). A None
        prior is the improper flat prior: logpdf 0 everywhere."""
        v = self.value if x is None else x
        if self.prior is None:
            return 0.0
        return self.prior.logpdf(v)

    def prior_pdf(self, x=None):
        return float(np.exp(self.prior_logpdf(x)))

    # -- value handling ------------------------------------------------

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        if v is not None and isinstance(v, str):
            v = self._parse_value(v)
        self._value = v
        if not isinstance(v, (int, float, np.floating)) or \
                isinstance(self, (strParameter, boolParameter)):
            self._dd = None
        elif self._dd is None or dd_np.to_f64(self._dd) != v:
            # two_sum of a non-finite value yields (nan, nan)
            self._dd = (dd_np.dd(float(v)) if np.isfinite(v)
                        else (float(v), 0.0))

    @property
    def quantity(self):  # PINT-compat alias
        return self._value

    @property
    def dd(self):
        """(hi, lo) host dd pair of the value (floats only)."""
        if self._dd is None:
            raise TypeError(f"{self.name} has no numeric dd value")
        return self._dd

    def set_dd(self, pair):
        self._dd = (float(pair[0]), float(pair[1]))
        self._value = self._dd[0] + self._dd[1]

    def add_delta(self, delta: float):
        """value += delta in dd (fit updates keep sub-f64 residue)."""
        self.set_dd(dd_np.add_f(self.dd, float(delta)))

    def _parse_value(self, tok: str):
        return float(tok.lower().replace("d", "e"))

    def _format_value(self) -> str:
        if self._dd is not None and self._dd[1] != 0.0:
            return dd_np_repr(self._dd)
        v = self._value
        return repr(float(v)) if isinstance(v, (float, np.floating)) \
            else str(v)

    def _format_uncertainty(self) -> str:
        """Uncertainty in the same units _format_value displays."""
        if self.uncertainty is None:
            return "-"
        return f"{self.uncertainty:.3g}"

    # -- par-file I/O --------------------------------------------------

    def from_tokens(self, tokens: List[str]):
        """Parse 'value [fit] [uncertainty]' par tokens."""
        if not tokens:
            raise ValueError(f"{self.name}: empty par line")
        self.value = tokens[0]
        if self.par_dtype is float and len(tokens[0]) > 17:
            try:
                self.set_dd(parse_float_dd(tokens[0]))
            except ValueError:
                pass
        if len(tokens) > 1 and tokens[1] in ("0", "1"):
            self.frozen = tokens[1] == "0"
            if len(tokens) > 2:
                self.uncertainty = self._parse_unc(tokens[2])
        elif len(tokens) > 1:
            # "KEY value uncertainty" (no fit flag) is legal
            try:
                self.uncertainty = self._parse_unc(tokens[1])
            except ValueError:
                pass

    def _parse_unc(self, tok: str) -> float:
        return abs(float(tok.lower().replace("d", "e")))

    def as_parfile_line(self) -> str:
        if self._value is None:
            return ""
        line = f"{self.name:<15} {self._format_value():>25}"
        if not self.frozen:
            line += " 1"
            if self.uncertainty is not None:
                line += f" {self.uncertainty:.8g}"
        return line + "\n"

    def __repr__(self):
        tag = "" if self.frozen else " (free)"
        return (f"<{type(self).__name__} {self.name}="
                f"{self._value!r} {self.units}{tag}>")


def dd_np_repr(pair) -> str:
    """Format a dd pair with enough digits to round-trip (~31 sig figs),
    via integer-scaled decimal reconstruction."""
    hi, lo = pair
    v = hi + lo
    if v == 0.0 or not np.isfinite(v):
        # plain-float repr: numpy-2 scalar reprs ('np.float64(inf)')
        # would not survive a par-file round trip
        return repr(float(hi))
    # Decimal digits: print hi+lo by accumulating decimal remainders
    from decimal import Decimal, getcontext
    getcontext().prec = 50
    return str((Decimal(hi) + Decimal(lo)).normalize())


class floatParameter(Parameter):
    """Plain float with a unit tag; optionally long-precision (dd) when
    parsed from >17-digit strings (F0 and friends)."""


class intParameter(Parameter):
    par_dtype = int

    def _parse_value(self, tok):
        return int(float(tok))


class boolParameter(Parameter):
    par_dtype = bool

    def _parse_value(self, tok):
        return tok.strip().upper() in ("1", "Y", "YES", "T", "TRUE")

    def _format_value(self):
        return "Y" if self._value else "N"


class strParameter(Parameter):
    par_dtype = str

    def _parse_value(self, tok):
        return tok


class MJDParameter(Parameter):
    """Epoch parameter (PEPOCH, T0, TASC, TZRMJD...): value is MJD;
    internally an exact (day, frac) split via dd."""

    def __init__(self, name, units: str = "MJD", **kw):
        super().__init__(name, units=units, **kw)

    def _parse_value(self, tok):
        from pint_tpu_torch.time.mjd import parse_mjd_string

        day, frac = parse_mjd_string(tok)
        self._dd = dd_np.add_f(frac, day)
        return self._dd[0] + self._dd[1]

    @property
    def day_frac(self):
        """(int day f64, frac dd pair), exact."""
        d = np.round(self._dd[0])
        return d, dd_np.add_f(dd_np.dd(self._dd[0] - d, self._dd[1]), 0.0)

    @Parameter.value.setter  # type: ignore[misc]
    def value(self, v):
        if isinstance(v, str):
            v = self._parse_value(v)
        elif v is not None:
            self._dd = dd_np.dd(float(v))
            v = float(v)
        self._value = v

    def _format_value(self):
        from pint_tpu_torch.time.mjd import mjd_to_str

        d, frac = self.day_frac
        return mjd_to_str(d, frac)


class AngleParameter(Parameter):
    """Angle stored in **radians**; par I/O in the declared unit:
    'H:M:S' (RAJ), 'D:M:S' (DECJ), or 'deg' (ELONG/ELAT).

    Reference: AngleParameter with astropy Angle; uncertainties here are
    reported in the same sexagesimal seconds as the reference par files.
    """

    def __init__(self, name, value=None, units="deg", **kw):
        super().__init__(name, value=value, units=units, **kw)

    def _parse_value(self, tok):
        if ":" in tok:
            parts = [float(p) for p in tok.split(":")]
            while len(parts) < 3:
                parts.append(0.0)
            sign = -1.0 if tok.strip().startswith("-") else 1.0
            mag = abs(parts[0]) + parts[1] / 60.0 + parts[2] / 3600.0
            if self.units == "H:M:S":
                return sign * mag * (np.pi / 12.0)
            return sign * mag * (np.pi / 180.0)
        v = float(tok)
        if self.units == "H:M:S":
            return v * (np.pi / 12.0)
        return v * (np.pi / 180.0)

    def _parse_unc(self, tok):
        # par-file uncertainties on sexagesimal angles are in seconds of
        # the respective unit (s of RA, arcsec of DEC)
        v = abs(float(tok))
        if self.units == "H:M:S":
            return v / 3600.0 * (np.pi / 12.0)
        if self.units == "D:M:S":
            return v / 3600.0 * (np.pi / 180.0)
        return v * (np.pi / 180.0)

    def _format_value(self):
        rad = self._value
        if self.units == "H:M:S":
            tot = rad * (12.0 / np.pi)
            unit_s = 3600.0
        elif self.units == "D:M:S":
            tot = rad * (180.0 / np.pi)
            unit_s = 3600.0
        else:
            return f"{rad * (180.0 / np.pi):.15f}"
        sign = "-" if tot < 0 else ""
        tot = abs(tot)
        h = int(tot)
        m = int((tot - h) * 60.0)
        s = (tot - h - m / 60.0) * unit_s
        if s >= 59.999999999995:  # carry
            s = 0.0
            m += 1
            if m == 60:
                m = 0
                h += 1
        return f"{sign}{h:02d}:{m:02d}:{s:.11f}"

    def _format_uncertainty(self):
        """Sexagesimal seconds (of RA hour / of arc), matching
        _parse_unc and the par-file convention."""
        if self.uncertainty is None:
            return "-"
        if self.units == "H:M:S":
            return f"{self.uncertainty * (12.0 / np.pi) * 3600.0:.3g}"
        if self.units == "D:M:S":
            return f"{self.uncertainty * (180.0 / np.pi) * 3600.0:.3g}"
        return f"{self.uncertainty * (180.0 / np.pi):.3g}"


class funcParameter(Parameter):
    """Read-only parameter derived from other model parameters
    (reference: funcParameter): ``func`` maps the values of ``params``
    (looked up on the attached model) to this parameter's value.
    Never fittable; excluded from par files."""

    def __init__(self, name, func, params, units: str = "",
                 description: str = "", **kw):
        self._func = func
        self._source_params = tuple(params)
        self._model = None
        super().__init__(name, value=None, units=units,
                         description=description, frozen=True, **kw)
        self._value = None

    @property
    def quantity(self):
        # keep the PINT-compat alias pointing at the derived value
        # (the inherited property reads _value, which is always None)
        return self.value

    @quantity.setter
    def quantity(self, v):
        if v is not None:
            raise AttributeError(
                f"{self.name} is derived ({self._source_params}); "
                "set its source parameters instead")

    def attach(self, model):
        self._model = model
        return self

    @property
    def value(self):
        if self._model is None:
            return None
        vals = []
        for nm in self._source_params:
            p = self._model.get_param(nm)
            if p.value is None:
                return None
            vals.append(p.value)
        return self._func(*vals)

    @value.setter
    def value(self, v):
        if v is not None:
            raise AttributeError(
                f"{self.name} is derived ({self._source_params}); "
                "set its source parameters instead")

    def as_parfile_line(self):
        return ""  # derived: never written


class maskParameter(floatParameter):
    """Parameter applying to a TOA subset selected by flag/MJD/freq/tel
    (reference: maskParameter; e.g. ``JUMP -fe L-wide 0.000216 1``).

    ``key`` is '-flagname' or one of 'mjd', 'freq', 'tel', 'name';
    ``key_value`` the matching value(s). Instances are numbered:
    JUMP1, JUMP2, ... with ``prefix`` = 'JUMP'.
    """

    def __init__(self, name, index=1, key=None, key_value=(), **kw):
        self.prefix = name
        self.index = index
        self.key = key
        self.key_value = list(key_value)
        super().__init__(f"{name}{index}", **kw)

    def from_tokens(self, tokens):
        """Parse '[-flag value | mjd a b | freq a b | tel t] value [fit]
        [unc]' — the mask key tokens precede the value."""
        toks = list(tokens)
        if not toks:
            raise ValueError(f"{self.name}: empty mask par line")
        k = toks[0].lower()
        if toks[0].startswith("-"):
            self.key = toks[0]
            self.key_value = [toks[1]]
            toks = toks[2:]
        elif k in ("mjd", "freq"):
            self.key = k
            self.key_value = [float(toks[1]), float(toks[2])]
            toks = toks[3:]
        elif k in ("tel", "name"):
            self.key = k
            self.key_value = [toks[1]]
            toks = toks[2:]
        super().from_tokens(toks)

    def select_mask(self, toas) -> np.ndarray:
        """Boolean (N,) mask of TOAs this parameter applies to
        (reference: src/pint/toa_select.py TOASelect)."""
        n = toas.ntoas
        if self.key is None:
            return np.ones(n, dtype=bool)
        if self.key.startswith("-"):
            flag = self.key[1:]
            want = str(self.key_value[0])
            return np.array(
                [f.get(flag) == want for f in toas.flags])
        if self.key == "mjd":
            m = toas.get_mjds()
            lo, hi = self.key_value
            return (m >= lo) & (m <= hi)
        if self.key == "freq":
            lo, hi = self.key_value
            return (toas.freq_mhz >= lo) & (toas.freq_mhz <= hi)
        if self.key in ("tel", "name"):
            want = str(self.key_value[0]).lower()
            if self.key == "tel":
                from pint_tpu_torch.observatory import get_observatory

                want_site = get_observatory(want).name
                return np.array([o == want_site for o in toas.obs])
            return np.array([nm == want for nm in toas.names])
        raise ValueError(f"unknown mask key {self.key!r}")

    def as_parfile_line(self):
        if self._value is None:
            return ""
        if self.key is None:
            keypart = ""
        elif self.key.startswith("-"):
            keypart = f"{self.key} {self.key_value[0]} "
        else:
            keypart = f"{self.key.upper()} " + " ".join(
                str(v) for v in self.key_value) + " "
        line = f"{self.prefix:<8} {keypart}{self._format_value()}"
        if not self.frozen:
            line += " 1"
            if self.uncertainty is not None:
                line += f" {self.uncertainty:.8g}"
        return line + "\n"


class prefixParameter(floatParameter):
    """One member of an indexed family (F2.., DMX_0001, GLF0_1...).

    ``prefix`` includes any trailing underscore ('DMX_'); the par name is
    prefix+index with the original zero padding preserved.
    """

    def __init__(self, name=None, prefix=None, index=0, index_str=None,
                 **kw):
        if name is not None and prefix is None:
            prefix, index_str, index = split_prefixed_name(name)
        self.prefix = prefix
        self.index = index
        self.index_str = index_str if index_str is not None else str(index)
        super().__init__(f"{prefix}{self.index_str}", **kw)


class pairParameter(Parameter):
    """Two-float parameter (reference: pairParameter, used by IFUNC/WAVE
    entries ``WAVE1 a b``)."""

    def __init__(self, name, value=(0.0, 0.0), **kw):
        super().__init__(name, value=None, **kw)
        self._value = tuple(float(v) for v in value)

    def from_tokens(self, tokens):
        self._value = (float(tokens[0]), float(tokens[1]))

    def _format_value(self):
        return f"{self._value[0]!r} {self._value[1]!r}"

    def as_parfile_line(self):
        return f"{self.name:<15} {self._format_value()}\n"
