"""tempo-like command-line fit driver (a port of
pint_tpu/scripts/pintempo.py; reference: src/pint/scripts/pintempo.py):
par + tim -> fit -> summary (+ output par). Runs on the GPU unless given
``--device cpu``:

    python -m pint_tpu_torch.scripts.pintempo model.par toas.tim
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintempo", description="Fit a timing model to TOAs")
    p.add_argument("parfile")
    p.add_argument("timfile")
    p.add_argument("--outfile", "-o", default=None,
                   help="write the post-fit model to this par file")
    p.add_argument("--fitter", default="auto",
                   choices=["auto", "wls", "gls", "downhill"],
                   help="solver (auto picks from model contents)")
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--plotfile", default=None,
                   help="write a pre/post-fit residual plot (png)")
    p.add_argument("--device", default=None,
                   help="torch device to fit on (default: cuda; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)

    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.fitter import Fitter, WLSFitter
    from pint_tpu_torch.gls import GLSFitter
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.residuals import Residuals

    dev = resolve_device(args.device)
    model, toas = get_model_and_toas(args.parfile, args.timfile,
                                     device=dev)
    print(f"Read {toas.ntoas} TOAs; model {model.name or '?'} with "
          f"{len(model.free_params)} free parameters on {dev}")
    pre = Residuals(toas, model)
    print(f"Prefit RMS: {pre.rms_weighted() * 1e6:.4f} us")

    if args.fitter == "wls":
        f = WLSFitter(toas, model)
    elif args.fitter == "gls":
        f = GLSFitter(toas, model)
    else:  # auto / downhill both go through Fitter.auto
        f = Fitter.auto(toas, model, downhill=True)
    kw = {} if args.maxiter is None else {"maxiter": args.maxiter}
    f.fit_toas(**kw)
    f.print_summary()
    if f.stats is not None:
        print(str(f.stats))

    if args.plotfile:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        mjd = toas.get_mjds()
        fig, ax = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
        ax[0].errorbar(mjd, 1e6 * pre.time_resids.cpu().numpy(),
                       yerr=toas.get_errors(), fmt=".")
        ax[0].set_ylabel("prefit [us]")
        ax[1].errorbar(mjd, 1e6 * f.resids.time_resids.cpu().numpy(),
                       yerr=toas.get_errors(), fmt=".")
        ax[1].set_ylabel("postfit [us]")
        ax[1].set_xlabel("MJD")
        fig.savefig(args.plotfile, dpi=100)
        print(f"Wrote {args.plotfile}")
    if args.outfile:
        with open(args.outfile, "w") as fh:
            fh.write(model.as_parfile())
        print(f"Wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
