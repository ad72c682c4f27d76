"""Spindown: rotational phase Σ Fᵢ·dtⁱ⁺¹/(i+1)! (a port of
pint_tpu/models/spindown.py; reference: src/pint/models/spindown.py
Spindown.spindown_phase, F0..Fn prefix parameters, PEPOCH).

The F0·dt product runs in double-double via dd_taylor_horner with DD
coefficients, so 19-digit par values keep all their bits.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    prefixParameter,
    split_prefixed_name,
)
from pint_tpu_torch.models.timing_model import SECS_PER_DAY, PhaseComponent
from pint_tpu_torch.ops.dd import DD, dd_mul_f, dd_sub, dd_sub_f
from pint_tpu_torch.ops.taylor import dd_taylor_horner


class Spindown(PhaseComponent):
    """Rotational phase Σ Fᵢ·dtⁱ⁺¹/(i+1)! (reference:
    src/pint/models/spindown.py Spindown.spindown_phase)."""

    category = "spindown"

    def __init__(self):
        super().__init__()
        f0 = self.add_param(floatParameter(
            "F0", units="Hz", frozen=True,
            description="spin frequency"))
        f1 = self.add_param(floatParameter("F1", units="Hz/s^1",
                                           value=0.0))
        # F0/F1 also belong to the 'F' prefix family, as in PINT
        f0.prefix, f0.index = "F", 0
        f1.prefix, f1.index = "F", 1
        self.add_param(MJDParameter(
            "PEPOCH", description="epoch of spin parameters"))

    def validate(self):
        if self.F0.value is None:
            raise ValueError("Spindown requires F0")

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        def f_dim(name):
            if name in ("F0", "F1"):
                i = int(name[1])
            else:
                _, _, i = split_prefixed_name(name)
            return parse_unit("Hz") / parse_unit("s") ** i

        return {"F*": f_dim, "F0": f_dim, "F1": f_dim,
                "PEPOCH": parse_unit("d")}

    def f_terms(self):
        """Ordered [F0, F1, F2, ...] parameter names present."""
        out = ["F0"]
        if "F1" in self.params:
            out.append("F1")
        extras = []
        for name in self.params:
            if name.startswith("F") and name not in ("F0", "F1"):
                try:
                    _, _, idx = split_prefixed_name(name)
                    extras.append((idx, name))
                except ValueError:
                    continue
        out.extend(nm for _, nm in sorted(extras))
        return out

    def add_f_term(self, index, value=0.0, frozen=True, uncertainty=None):
        p = prefixParameter(prefix="F", index=index, value=value,
                            units=f"Hz/s^{index}", frozen=frozen,
                            uncertainty=uncertainty)
        self.add_param(p)
        return p

    def dt(self, pv, tb: DD) -> DD:
        """tb is seconds since model ref_day; shift to seconds since
        PEPOCH. (PEPOCH − ref) is ≲ tens of days → dd keeps it exact."""
        pep_days = dd_sub_f(pv["PEPOCH"], self._parent.ref_day)
        return dd_sub(tb, dd_mul_f(pep_days, SECS_PER_DAY))

    def phase(self, pv, batch, cache, ctx, tb: DD) -> DD:
        dt = self.dt(pv, tb)
        coeffs = [DD(torch.zeros_like(dt.hi), torch.zeros_like(dt.hi))]
        coeffs += [pv[nm] for nm in self.f_terms()]
        return dd_taylor_horner(dt, coeffs)

    def linear_design_names(self):
        """F1+ only: F0 also scales other components' phases (PhaseJump
        converts seconds with it), so it stays on AD. A fitted PEPOCH
        pivots dt, so then everything stays on AD."""
        if not self.PEPOCH.frozen or self.PEPOCH.value is None:
            return []
        return [nm for nm in self.f_terms()
                if nm != "F0" and not self.params[nm].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        names = self.linear_design_names()
        if not names:
            return {}
        dt_dd = self.dt(pv, ctx["tb"])
        dts = dt_dd.hi + dt_dd.lo  # f64 suffices for a design column
        terms = self.f_terms()
        return {nm: ("phase",
                     dts ** (i + 1) / math.factorial(i + 1))
                for i, nm in enumerate(terms) if nm in names}
