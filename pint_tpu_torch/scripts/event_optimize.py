"""MCMC-optimize a timing model against photon phases with a template
likelihood (a port of pint_tpu/scripts/event_optimize.py; reference:
src/pint/scripts/event_optimize.py, emcee replaced by the port's
ensemble sampler).

Reads a barycentred FITS event file, measures the weighted H-test of the
initial model, seeds a pulse-profile template by ML (or reads one with
``--template``), samples the free timing parameters against the unbinned
photon likelihood with ``PhotonMCMCFitter`` and reports the final H-test.
Runs on the GPU unless given ``--device cpu``:

    python -m pint_tpu_torch.scripts.event_optimize events.fits model.par
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
        prog="event_optimize",
        description="MCMC timing-model optimization on photon events")
    p.add_argument("eventfile", help="barycentered event FITS")
    p.add_argument("parfile")
    p.add_argument("--mission", default=None)
    p.add_argument("--weightcol", default=None)
    p.add_argument("--ncomp", type=int, default=1,
                   help="Gaussian components in the seed template")
    p.add_argument("--template", default=None,
                   help="profile template file (see "
                        "pint_tpu_torch.templates.read_template); skips "
                        "the automatic template seeding")
    p.add_argument("--nwalkers", type=int, default=32)
    p.add_argument("--nsteps", type=int, default=200)
    p.add_argument("--burn", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--outfile", default=None,
                   help="write the optimized par file here")
    p.add_argument("--chains-npz", default=None,
                   help="dump the full walker chain + lnprob here")
    p.add_argument("--device", default=None,
                   help="torch device to evaluate on (default: cuda; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    from pint_tpu_torch import resolve_device
    from pint_tpu_torch.event_toas import get_event_weights, load_fits_TOAs
    from pint_tpu_torch.eventstats import h_sig, hmw
    from pint_tpu_torch.mcmc_fitter import PhotonMCMCFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.templates import LCFitter, LCGaussian, LCTemplate

    dev = resolve_device(args.device)
    secs = {}
    t0 = time.perf_counter()
    model = get_model(args.parfile, device=dev)
    toas = load_fits_TOAs(args.eventfile, mission=args.mission,
                          weightcolumn=args.weightcol,
                          ephem=model.EPHEM.value,
                          planets=bool(model.PLANET_SHAPIRO.value),
                          device=dev)
    weights = get_event_weights(toas)
    secs["ingest"] = time.perf_counter() - t0

    def htest():
        t = time.perf_counter()
        phases = torch.remainder(model.phase(toas).frac, 1.0)
        h = hmw(phases, weights, device=dev)
        secs["htest"] = secs.get("htest", 0.0) + time.perf_counter() - t
        return phases, h

    phases_t, h0 = htest()
    phases = phases_t.cpu().numpy()
    print(f"Read {toas.ntoas} photons; initial Htest {h0:.1f} "
          f"({h_sig(h0):.1f} sigma)")

    t1 = time.perf_counter()
    if args.template:
        from pint_tpu_torch.templates import read_template

        template = read_template(args.template, device=dev)
        print(f"Read template from {args.template}:\n{template}")
    else:
        # seed template by ML on the initial phases; the peak location
        # comes from the first Fourier harmonic (a far-off location
        # seed collapses the ML fit into the uniform-background local
        # minimum)
        w = weights if weights is not None else np.ones_like(phases)
        c1 = np.sum(w * np.exp(2j * np.pi * phases))
        loc0 = float(np.angle(c1) / (2 * np.pi)) % 1.0
        pulsed_frac = min(0.9, max(0.1,
                                   2.0 * np.abs(c1) / np.sum(w)))
        ncomp = max(1, args.ncomp)
        prims = [LCGaussian() for _ in range(ncomp)]
        locs = [(loc0 + k / ncomp) % 1.0 for k in range(ncomp)]
        template = LCTemplate(prims,
                              norms=[pulsed_frac / ncomp] * ncomp,
                              locs=locs, widths=[0.05] * ncomp,
                              device=dev)
        tfit = LCFitter(template, phases_t, weights=weights, device=dev)
        res = tfit.fit()
        print(f"Template ML: logL={res['loglikelihood']:.1f} "
              f"locs={np.round(template.locs, 4)} "
              f"norms={np.round(template.norms, 3)}")
        if template.norms.sum() < 0.05:
            print("WARNING: template collapsed to background — phases "
                  "may be unpulsed or the seed failed; aborting "
                  "before MCMC")
            return 1
    _sync(dev)
    secs["template"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    fitter = PhotonMCMCFitter(toas, model, template, weights=weights,
                              nwalkers=args.nwalkers, rng=rng)
    lnmax = fitter.fit_toas(nsteps=args.nsteps, burn=args.burn)
    secs["mcmc"] = time.perf_counter() - t1
    print(f"MCMC done: acc="
          f"{fitter.sampler.acceptance_fraction:.2f} "
          f"max lnL={lnmax:.1f}")
    tau = fitter.sampler.get_autocorr_time()
    conv = fitter.sampler.converged(tau=tau)
    print(f"autocorr time (steps): max {np.nanmax(tau):.1f}; "
          f"chain {'converged' if conv else 'SHORT'}"
          f" by the nsteps > 50*tau rule")
    if args.chains_npz:
        np.savez(args.chains_npz,
                 chain=fitter.sampler.chain,
                 lnprob=fitter.sampler.lnprob,
                 labels=np.array(fitter.param_labels),
                 tau=tau)
        print(f"Wrote {args.chains_npz}")
    _, h1 = htest()
    print(f"Final Htest {h1:.1f} ({h_sig(h1):.1f} sigma)")
    for name in fitter.param_labels:
        par = model.get_param(name)
        print(f"  {name} = {par.value} +- {par.uncertainty:.3g}")
    if args.outfile:
        with open(args.outfile, "w") as fh:
            fh.write(model.as_parfile())
        print(f"Wrote {args.outfile}")
    secs["total"] = time.perf_counter() - t0
    print("Stage seconds: " + json.dumps({**secs, "device": str(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
