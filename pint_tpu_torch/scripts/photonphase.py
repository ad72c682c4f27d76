"""Assign model pulse phases to photon events and test for pulsations
(a port of pint_tpu/scripts/photonphase.py; reference:
src/pint/scripts/photonphase.py).

Reads a (barycentred) FITS event file, evaluates the timing model's
absolute phase at every photon on the device, reports the weighted
H-test, and can write the phases back as a PULSE_PHASE column in a new
FITS file, plus an optional npz dump. Runs on the GPU unless given
``--device cpu``:

    python -m pint_tpu_torch.scripts.photonphase events.fits model.par
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="photonphase",
        description="Assign pulse phases to FITS photon events")
    p.add_argument("eventfile", help="barycentered event FITS file")
    p.add_argument("parfile", help="timing model .par file")
    p.add_argument("--mission", default=None,
                   help="mission name for MJDREF fallback "
                        "(fermi/nicer/rxte/nustar/swift/xmm)")
    p.add_argument("--weightcol", default=None,
                   help="photon-weight column name (e.g. Fermi "
                        "MODEL_WEIGHT)")
    p.add_argument("--orbfile", default=None,
                   help="spacecraft orbit FITS (required for "
                        "un-barycentered TT event files)")
    p.add_argument("--minmjd", type=float, default=-np.inf)
    p.add_argument("--maxmjd", type=float, default=np.inf)
    p.add_argument("--outfile", default=None,
                   help="write a FITS copy with a PULSE_PHASE column")
    p.add_argument("--npz", default=None,
                   help="write phases (+weights) to this .npz")
    p.add_argument("--plotfile", default=None,
                   help="write a phaseogram png here")
    p.add_argument("--device", default=None,
                   help="torch device to evaluate on (default: cuda; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.event_toas import get_event_weights, load_fits_TOAs
    from pint_tpu_torch.eventstats import h_sig, hmw
    from pint_tpu_torch.io.fits import read_events_fits, write_events_fits
    from pint_tpu_torch.models import get_model

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model = get_model(args.parfile, device=dev)
    toas = load_fits_TOAs(args.eventfile, mission=args.mission,
                          weightcolumn=args.weightcol,
                          minmjd=args.minmjd, maxmjd=args.maxmjd,
                          ephem=model.EPHEM.value,
                          planets=bool(model.PLANET_SHAPIRO.value),
                          orbit_file=args.orbfile, device=dev)
    print(f"Read {toas.ntoas} photons from {args.eventfile}")
    t1 = time.perf_counter()
    model.get_cache(toas)   # pack the batch and the TZR row, copy them over
    _sync(dev)
    t2 = time.perf_counter()
    phase = model.phase(toas)
    phases = torch.remainder(phase.frac, 1.0)
    _sync(dev)
    t3 = time.perf_counter()
    weights = get_event_weights(toas)
    h = hmw(phases, weights, device=dev)
    t4 = time.perf_counter()
    sig = h_sig(h)
    wtxt = " (weighted)" if weights is not None else ""
    print(f"Htest{wtxt}: {h:.2f}  ({sig:.2f} sigma)")
    print("Stage seconds: " + json.dumps({
        "ingest": t1 - t0, "batch": t2 - t1, "phase": t3 - t2,
        "htest": t4 - t3, "total": t4 - t0, "device": str(dev)}))

    phases = phases.cpu().numpy()
    if args.plotfile:
        from pint_tpu_torch.plot_utils import phaseogram

        phaseogram(np.asarray(toas.get_mjds()), phases,
                   weights=weights,
                   title=f"{model.name or ''} H={h:.1f}",
                   plotfile=args.plotfile)
        print(f"Wrote {args.plotfile}")
    if args.npz:
        np.savez(args.npz, phases=phases,
                 weights=(weights if weights is not None
                          else np.ones_like(phases)))
        print(f"Wrote {args.npz}")
    if args.outfile:
        cols, header = read_events_fits(args.eventfile)
        cols["PULSE_PHASE"] = phases.astype(np.float64)
        keep = {k: v for k, v in header.items()
                if k in ("TIMESYS", "TIMEREF", "TELESCOP", "INSTRUME",
                         "MJDREFI", "MJDREFF", "TIMEZERO", "TIMEUNIT")}
        write_events_fits(args.outfile, cols, header_extra=keep)
        print(f"Wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
