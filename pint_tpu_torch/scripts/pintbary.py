"""Quick barycentering of arbitrary times (a port of
pint_tpu/scripts/pintbary.py; reference: src/pint/scripts/pintbary.py):
UTC MJDs at a site -> barycentric TDB MJDs for a given sky position (or
par file). The delays are one ``model.delay`` of the batch on the GPU,
unless given ``--device cpu``; the subtraction from TDB is on the host:

    python -m pint_tpu_torch.scripts.pintbary 56000.0 --ra 03:30:00 \
        --dec 22:00:00
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintbary", description="Barycenter times")
    p.add_argument("mjds", nargs="+", type=float, help="UTC MJD(s)")
    p.add_argument("--obs", default="gbt")
    p.add_argument("--freq", type=float, default=float("inf"),
                   help="MHz (dispersion removed if par has DM)")
    p.add_argument("--parfile", default=None)
    p.add_argument("--ra", default=None, help="hh:mm:ss.s")
    p.add_argument("--dec", default=None, help="dd:mm:ss.s")
    p.add_argument("--ephem", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the delays (default: cuda; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    # the reference's JAX compile cache has no counterpart: eager torch
    # compiles nothing
    import io
    import warnings

    import numpy as np

    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.timing_model import copy_model
    from pint_tpu_torch.toa import get_TOAs_array

    dev = resolve_device(args.device)
    if args.parfile:
        model = get_model(args.parfile, device=dev)
    elif args.ra and args.dec:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = get_model(io.StringIO(
                f"PSR BARY\nRAJ {args.ra}\nDECJ {args.dec}\n"
                f"F0 1.0\nPEPOCH 55000\nUNITS TDB\n"), device=dev)
    else:
        p.error("give --parfile or --ra/--dec")

    # barycentering stops at solar-system delays: strip any binary
    # component (the reference pintbary likewise never removes the
    # orbital delay)
    binaries = [nm for nm in model.components
                if nm.startswith("Binary")]
    if binaries:
        model = copy_model(model)
        for nm in binaries:
            model.remove_component(nm)
        model.invalidate_cache()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        toas = get_TOAs_array(np.asarray(args.mjds, dtype=np.float64),
                              obs=args.obs, freqs=args.freq,
                              errors=1.0,
                              ephem=(args.ephem or model.EPHEM.value),
                              device=dev)
    delay = model.delay(toas).cpu().numpy()
    tdb = toas.tdb_day + toas.tdb_frac[0] + toas.tdb_frac[1]
    bat = tdb - delay / 86400.0
    for m_in, m_out in zip(args.mjds, bat):
        print(f"{m_in:.10f} -> {m_out:.13f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
