"""Build-time unit discipline (SURVEY §5, last open row).

The reference leans on astropy.units at runtime; a TPU-first design
cannot afford unit objects on device arrays (they would block fusion
and add per-op host work), so units live ENTIRELY at build/trace time:

- every Parameter carries a ``units`` string (par-file units — these
  define the design-matrix column units, reference:
  TimingModel.designmatrix);
- ``ToaBatch.UNITS`` documents the unit of every batch leaf;
- each Component family declares the expected DIMENSION of its
  parameters (``Component.param_dimensions``), and
  ``check_model_units`` verifies, at model-build time, that every
  device parameter's unit string parses and matches the declared
  dimension. A component wired with wrong units (PB in seconds, an
  epoch in years, a frequency-derivative ladder off by one power of
  time) fails with a clear UnitError before anything is traced.

The algebra is deliberately tiny: dimensions over (time, length,
angle, mass, electron-column), exact rational exponents, and a parser
for the compound forms used in par files ("pc cm^-3", "Hz/s^2",
"mas/yr", "1/s^2", "lt-s/s"). No conversions happen here — device code
converts explicitly at its boundaries (that design is what keeps the
XLA graphs clean); this layer only guarantees the declarations agree.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional, Tuple

__all__ = ["Unit", "UnitError", "parse_unit", "check_model_units",
           "DIMENSIONLESS"]


class UnitError(ValueError):
    """A unit string failed to parse or a dimension check failed."""


# base dimensions: (time, length, angle, mass, electron column dens.)
_DIMS = ("T", "L", "A", "M", "NE")

# atom -> dimension exponents (no scale factors: this layer checks
# dimensions, not magnitudes)
_ATOMS: Dict[str, Dict[str, Fraction]] = {
    "s": {"T": Fraction(1)},
    "ms": {"T": Fraction(1)},
    "us": {"T": Fraction(1)},
    "ns": {"T": Fraction(1)},
    "sec": {"T": Fraction(1)},
    "second": {"T": Fraction(1)},
    "d": {"T": Fraction(1)},
    "day": {"T": Fraction(1)},
    "mjd": {"T": Fraction(1)},
    "yr": {"T": Fraction(1)},
    "year": {"T": Fraction(1)},
    "hz": {"T": Fraction(-1)},
    "mhz": {"T": Fraction(-1)},
    "ghz": {"T": Fraction(-1)},
    "m": {"L": Fraction(1)},
    "km": {"L": Fraction(1)},
    "cm": {"L": Fraction(1)},
    "au": {"L": Fraction(1)},
    "pc": {"L": Fraction(1)},
    "kpc": {"L": Fraction(1)},
    "ls": {"T": Fraction(1)},      # light-second: time-valued length
    "lt-s": {"T": Fraction(1)},
    "rad": {"A": Fraction(1)},
    "deg": {"A": Fraction(1)},
    "arcsec": {"A": Fraction(1)},
    "mas": {"A": Fraction(1)},
    "uas": {"A": Fraction(1)},
    "h:m:s": {"A": Fraction(1)},   # sexagesimal RA (par I/O converts)
    "d:m:s": {"A": Fraction(1)},
    "hourangle": {"A": Fraction(1)},
    "turn": {"A": Fraction(1)},
    "cycle": {"A": Fraction(1)},
    "msun": {"M": Fraction(1)},
    "kg": {"M": Fraction(1)},
    "strain": {},          # dimensionless (GW convention)
    "1": {},
    "": {},
}


class Unit:
    """A pure dimension vector with exact rational exponents."""

    __slots__ = ("dims",)

    def __init__(self, dims: Optional[Dict[str, Fraction]] = None):
        self.dims = {k: v for k, v in (dims or {}).items() if v != 0}

    def __mul__(self, other: "Unit") -> "Unit":
        out = dict(self.dims)
        for k, v in other.dims.items():
            out[k] = out.get(k, Fraction(0)) + v
        return Unit(out)

    def __truediv__(self, other: "Unit") -> "Unit":
        return self * other ** -1

    def __pow__(self, n) -> "Unit":
        f = Fraction(n)
        return Unit({k: v * f for k, v in self.dims.items()})

    def __eq__(self, other) -> bool:
        return isinstance(other, Unit) and self.dims == other.dims

    def __hash__(self):
        return hash(tuple(sorted(self.dims.items())))

    def __repr__(self):
        if not self.dims:
            return "Unit(1)"
        parts = [f"{k}^{v}" if v != 1 else k
                 for k, v in sorted(self.dims.items())]
        return "Unit(" + " ".join(parts) + ")"


DIMENSIONLESS = Unit()


def _parse_atom(tok: str) -> Unit:
    """One factor: ``atom`` or ``atom^exp`` (exp may be negative or
    fractional like 2/3). ``sqrt(X)`` is X^(1/2); ``log10`` /
    ``log10(X)`` is dimensionless (a logarithm)."""
    tok = tok.strip()
    if not tok:
        return DIMENSIONLESS
    low = tok.lower()
    if low == "log10" or (low.startswith("log10(")
                          and low.endswith(")")):
        return DIMENSIONLESS
    if low.startswith("sqrt(") and low.endswith(")"):
        return _parse_atom(tok[5:-1]) ** Fraction(1, 2)
    if "^" in tok:
        base, exp = tok.split("^", 1)
    elif tok[-1].isdigit() and tok[:-2] and tok[-2] in "-+" \
            and tok[:-2].lower() in _ATOMS:
        base, exp = tok[:-2], tok[-2:]      # "cm-3" style
    elif tok[-1].isdigit() and tok[:-1].lower() in _ATOMS:
        base, exp = tok[:-1], tok[-1]        # "s2" style
    else:
        base, exp = tok, "1"
    b = base.strip().lower()
    if b not in _ATOMS:
        raise UnitError(f"unknown unit atom {base!r} in {tok!r}")
    try:
        e = Fraction(exp.strip())
    except (ValueError, ZeroDivisionError) as err:
        raise UnitError(f"bad exponent {exp!r} in {tok!r}") from err
    return Unit(dict(_ATOMS[b])) ** e


def parse_unit(text: Optional[str]) -> Unit:
    """Parse a par-file unit string to its dimension. Handles the
    forms parameters actually use: "pc cm^-3 / yr^2", "Hz/s^2",
    "mas/yr", "1/s^2", "lt-s/s", "", None."""
    if text is None:
        return DIMENSIONLESS
    text = text.strip()
    if not text:
        return DIMENSIONLESS
    out = DIMENSIONLESS
    # split on '/' first: everything after each '/' divides
    num, *dens = text.split("/")
    for tok in num.replace("·", " ").replace("*", " ").split():
        out = out * _parse_atom(tok)
    for den in dens:
        for i, tok in enumerate(
                den.replace("·", " ").replace("*", " ").split()):
            out = out / _parse_atom(tok)
    return out


# convenience dimensions for specs
TIME = parse_unit("s")
ANGLE = parse_unit("rad")
FREQ = parse_unit("Hz")
NE_COL = parse_unit("pc cm^-3")
MASS = parse_unit("Msun")


def check_model_units(model) -> None:
    """Walk every component's declared parameter dimensions and verify
    each device parameter's unit string agrees. Raises UnitError with
    the component, parameter, declared and expected units. Called from
    TimingModel.validate (build time — zero trace/runtime cost)."""
    for cname, comp in model.components.items():
        spec = comp.param_dimensions()
        if not spec:
            continue
        for pname, p in comp.params.items():
            expected = _spec_lookup(spec, pname)
            if callable(expected):
                expected = expected(pname)
            if expected is None:
                continue
            try:
                got = parse_unit(getattr(p, "units", None))
            except UnitError as e:
                raise UnitError(
                    f"{cname}.{pname}: unparseable units "
                    f"{p.units!r}: {e}") from e
            if got != expected:
                raise UnitError(
                    f"{cname}.{pname}: declared units {p.units!r} "
                    f"have dimension {got}, but this slot requires "
                    f"{expected} — seconds/days/frequency mixups are "
                    f"exactly what this check exists to catch")


def _spec_lookup(spec: Dict[str, Unit], pname: str):
    """Exact name match, else the longest matching 'PREFIX*' entry
    (the '*' part must be numeric, possibly after an underscore)."""
    if pname in spec:
        return spec[pname]
    best = None
    for key, dim in spec.items():
        if not key.endswith("*"):
            continue
        stem = key[:-1]
        if pname.startswith(stem):
            rest = pname[len(stem):].lstrip("_")
            if rest.isdigit() and (best is None or
                                   len(stem) > best[0]):
                best = (len(stem), dim)
    return best[1] if best else None
