"""Simulate fake TOAs to a tim file (a port of
pint_tpu/scripts/zima.py; reference: src/pint/scripts/zima.py). The
model's phase runs on the GPU unless given ``--device cpu``; the white
and correlated draws come from numpy's ``default_rng(--seed)``, in the
reference's order:

    python -m pint_tpu_torch.scripts.zima model.par sim.tim --ntoa 100
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="zima", description="Simulate TOAs from a timing model")
    p.add_argument("parfile")
    p.add_argument("timfile", help="output tim file")
    p.add_argument("--ntoa", type=int, default=100)
    p.add_argument("--startMJD", type=float, default=56000.0)
    p.add_argument("--duration", type=float, default=400.0,
                   help="days")
    p.add_argument("--error", type=float, default=1.0,
                   help="TOA uncertainty [us]")
    p.add_argument("--obs", default="gbt")
    p.add_argument("--freq", type=float, default=1400.0)
    p.add_argument("--addnoise", action="store_true",
                   help="add a white-noise draw at the TOA errors")
    p.add_argument("--addcorrnoise", action="store_true",
                   help="also draw the model's correlated noise")
    p.add_argument("--inputtim", default=None,
                   help="take MJDs/freqs/errors from this tim instead")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the model's phase (default: "
                        "cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    import numpy as np

    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import (
        make_fake_toas_fromtim,
        make_fake_toas_uniform,
    )

    model = get_model(args.parfile, device=resolve_device(args.device))
    rng = np.random.default_rng(args.seed)
    if args.inputtim:
        toas = make_fake_toas_fromtim(
            args.inputtim, model, add_noise=args.addnoise,
            add_correlated_noise=args.addcorrnoise, rng=rng)
    else:
        toas = make_fake_toas_uniform(
            args.startMJD, args.startMJD + args.duration, args.ntoa,
            model, error_us=args.error, obs=args.obs,
            freq_mhz=args.freq, add_noise=args.addnoise,
            add_correlated_noise=args.addcorrnoise, rng=rng)
    toas.write_TOA_file(args.timfile)
    print(f"Wrote {toas.ntoas} simulated TOAs to {args.timfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
