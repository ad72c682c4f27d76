"""Publication-style LaTeX table of a fitted timing solution (a port of
pint_tpu/scripts/pintpublish.py; reference:
src/pint/scripts/pintpublish.py). The fit (Fitter.auto) runs on the GPU
unless given ``--device cpu``:

    python -m pint_tpu_torch.scripts.pintpublish model.par toas.tim
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "publish_table"]


def publish_table(fitter, include_fixed: bool = False) -> str:
    """LaTeX table body: fitted parameters with parenthesized
    uncertainties, fit statistics, and derived quantities when the
    model is binary."""
    from pint_tpu_torch.utils import format_uncertainty

    model = fitter.model
    res = fitter.resids
    rows = []

    def esc(s: str) -> str:
        return s.replace("_", r"\_")

    rows.append(r"\begin{tabular}{ll}")
    rows.append(r"\hline")
    rows.append(rf"Pulsar & {esc(model.name or model.PSR.value or '?')}"
                r" \\")
    rows.append(rf"TOAs & {fitter.toas.ntoas} \\")
    rows.append(rf"Weighted RMS (\,$\mu$s) & "
                rf"{res.rms_weighted() * 1e6:.3f} \\")
    rows.append(rf"$\chi^2$/dof & {float(res.chi2):.2f}/{res.dof} \\")
    rows.append(r"\hline")
    rows.append(r"\multicolumn{2}{c}{Fitted parameters} \\")
    rows.append(r"\hline")
    from pint_tpu_torch.models.parameter import (AngleParameter,
                                                 MJDParameter)

    for nm in model.free_params:
        p = model.get_param(nm)
        if isinstance(p, (AngleParameter, MJDParameter)):
            # sexagesimal / MJD values: use the parameter's own
            # par-convention formatter (raw radians would be wrong)
            val = esc(p._format_value())
            if p.uncertainty is not None:
                val += rf" $\pm$ {esc(p._format_uncertainty())}"
        else:
            val = format_uncertainty(p.value, p.uncertainty)
        unit = f" ({esc(str(p.units))})" if p.units else ""
        rows.append(rf"{esc(nm)}{unit} & {val} \\")
    if include_fixed:
        rows.append(r"\hline")
        rows.append(r"\multicolumn{2}{c}{Fixed parameters} \\")
        rows.append(r"\hline")
        for nm in model.params:  # params is a list of names
            p = model.get_param(nm)
            if p.frozen and p.value is not None and \
                    not isinstance(p.value, (str, bool)):
                try:
                    rows.append(rf"{esc(nm)} & {float(p.value)!r} \\")
                except (TypeError, ValueError):
                    continue
    binary = next((n for n in model.components
                   if n.startswith("Binary")), None)
    if binary:
        try:
            pb_days = model.get_param("PB").value
            x_lts = model.get_param("A1").value
        except KeyError:
            pb_days = x_lts = None
        if pb_days and x_lts:
            from pint_tpu_torch.derived_quantities import mass_funct

            rows.append(r"\hline")
            rows.append(r"\multicolumn{2}{c}{Derived quantities} \\")
            rows.append(r"\hline")
            fm = mass_funct(pb_days, x_lts)
            rows.append(rf"Mass function ($M_\odot$) & {fm:.6g} \\")
    rows.append(r"\hline")
    rows.append(r"\end{tabular}")
    return "\n".join(rows) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintpublish",
        description="Fit a timing model and print a LaTeX results "
                    "table")
    p.add_argument("parfile")
    p.add_argument("timfile")
    p.add_argument("-o", "--out", default=None,
                   help="write the table to this file (default stdout)")
    p.add_argument("--include-fixed", action="store_true",
                   help="also list fixed numeric parameters")
    p.add_argument("--no-fit", action="store_true",
                   help="tabulate the par-file solution without "
                        "refitting")
    p.add_argument("--device", default=None,
                   help="torch device of the fit (default: cuda; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.models import get_model_and_toas

    model, toas = get_model_and_toas(args.parfile, args.timfile,
                                     device=resolve_device(args.device))
    f = Fitter.auto(toas, model)
    if not args.no_fit:
        f.fit_toas()
    table = publish_table(f, include_fixed=args.include_fixed)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(table)
        print(f"Wrote {args.out}")
    else:
        sys.stdout.write(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
