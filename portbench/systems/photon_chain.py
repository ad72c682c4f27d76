"""A photon timing fit: barycentred photons made from the seed, the port's
timing model, TOA table, template and ``PhotonMCMCFitter`` over them, and
the comparison of what the timed chain returned with the plain
reference.

The photon columns (TDB epochs as whole days and a double-double day
fraction, the observatory at the barycentre, the Sun's position about
it) are the benchmark's own, made by the configuration's reference
module (``simulate``), and reach the port through ``TOAs.from_npz``, the
program's loader of a processed TOA table, from memory, with no weights
column (NICER events are unweighted). The port parses the
configuration's par file itself and builds its template from the
configuration's three Gaussians.
"""

from __future__ import annotations

import gc
import io
import json

import numpy as np
import torch


class System:
    """The program under test (``fitter``, its ``model`` and ``toas``),
    the inputs handed to it and to the reference (``inputs``), the sizes
    the readers need (``dims``), the walkers' start scale (``sigma``,
    the reference's errors of F0 and F1) and the H-test's harmonics
    (``m``)."""

    def __init__(self, fitter, inputs, dims, sigma, m):
        self.fitter = fitter
        self.model = fitter.model
        self.toas = fitter.toas
        self.inputs = inputs
        self.dims = dims
        self.sigma = sigma
        self.m = m

    def counters(self) -> dict:
        return self.fitter.metrics.snapshot()

    def htest(self, theta) -> float:
        """``event_optimize``'s closing H-test at ``theta``: the model's
        free parameters set to it, the photons' phases through the
        model's phase chain, then ``eventstats.hm`` (K1 on a card)."""
        from pint_tpu_torch.eventstats import hm

        model = self.model
        for name, v in zip(self.fitter.param_labels, theta):
            model.get_param(name).set_dd((float(v), 0.0))
        model.invalidate_cache(params_only=True)
        phases = torch.remainder(model.phase(self.toas).frac, 1.0)
        return hm(phases, m=self.m, device=model.device)

    def release(self):
        """Free the program's state before the reference runs."""
        self.fitter = self.model = self.toas = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _npz(cols) -> io.BytesIO:
    """The columns as the snapshot ``TOAs.from_npz`` reads, in memory:
    barycentred events, no weights column."""
    n = len(cols["freq_mhz"])
    buf = io.BytesIO()
    np.savez(buf, mjd_day=cols["mjd_day"], mjd_frac_hi=cols["mjd_frac_hi"],
             mjd_frac_lo=cols["mjd_frac_lo"], freq_mhz=cols["freq_mhz"],
             error_us=cols["error_us"], obs=np.full(n, "barycenter"),
             names=np.char.add("photon", np.arange(n).astype(str)),
             flags_json=np.array(json.dumps([{}] * n)),
             meta_json=np.array(json.dumps({"clock_applied": True,
                                            "ephem": "benchmark-geometry",
                                            "planets": False})),
             tdb_day=cols["tdb_day"], tdb_frac_hi=cols["tdb_frac_hi"],
             tdb_frac_lo=cols["tdb_frac_lo"],
             ssb_obs_pos=cols["ssb_obs_pos"],
             ssb_obs_vel=cols["ssb_obs_vel"],
             obs_sun_pos=cols["obs_sun_pos"])
    buf.seek(0)
    return buf


def build(cfg, seed, device) -> System:
    """The photons from the seed, the port's model, TOA table, template
    and photon fitter over them on ``device``, and the walkers' start
    scale from the reference's curvature."""
    from pint_tpu_torch.mcmc_fitter import PhotonMCMCFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.templates import LCGaussian, LCTemplate
    from pint_tpu_torch.toa import TOAs

    from portbench import registry

    ref = registry.module("reference", cfg["name"])
    cols = ref.simulate(cfg, seed, device)
    sigma = ref.spin_sigma(cols, cfg, device)
    toas = TOAs.from_npz(_npz(cols), device=device)
    model = get_model(io.StringIO("\n".join(ref.par_lines(cfg)) + "\n"),
                      device=device)
    norms, locs, widths = ref.template_params(cfg)
    template = LCTemplate([LCGaussian() for _ in norms], norms=list(norms),
                          locs=list(locs), widths=list(widths),
                          device=device)
    fitter = PhotonMCMCFitter(toas, model, template,
                              rng=np.random.default_rng([int(seed), 0xF00]))
    dims = {"photons": toas.ntoas, "nparams": fitter.nparams,
            "m": int(cfg["htest_m"])}
    return System(fitter, cols, dims, sigma, int(cfg["htest_m"]))


def _sample(calls, cfg, seed):
    """The window's answered calls: (walker points, their log L) at a
    sample of ``check_points`` chain states drawn from the seed, and
    (point, H) of as many calls."""
    ok = [c for c in calls if c["ok"]]
    if not ok:
        return None
    th = np.concatenate([c["thetas"] for c in ok])
    got = np.concatenate([c["values"] for c in ok])
    k = int(cfg["check_points"])
    rng = np.random.default_rng([int(seed), 0x5EED])
    pick = np.sort(rng.choice(len(got), size=min(len(got), k),
                              replace=False))
    hp = np.sort(rng.choice(len(ok), size=min(len(ok), k), replace=False))
    best = np.stack([ok[i]["best"] for i in hp])
    h = np.asarray([ok[i]["h"] for i in hp])
    return th[pick], got[pick], best, h


def _gaps(ref, inputs, cfg, s, device, dtype=torch.float64):
    th, got, best, h = s
    want = ref.lnlike(inputs, cfg, th, device, dtype)
    hw = ref.htest(inputs, cfg, best, device, dtype)
    return {"lnlike_gap": float(np.max(np.abs(got - want))),
            "htest_gap": float(np.max(np.abs(h - hw) / np.abs(hw)))}


def check(system, calls, ref, cfg, seed, device):
    """{"lnlike_gap": the widest gap [nats] between the walker
    log-likelihoods the timed calls returned and the reference's, over a
    sample of the window's chain states drawn from the seed;
    "htest_gap": the widest relative gap between the calls' H values and
    the reference's H at the same points}; None as the values when no
    call came back."""
    s = _sample(calls, cfg, seed)
    if s is None:
        return {"lnlike_gap": None, "htest_gap": None}
    return _gaps(ref, system.inputs, cfg, s, device)


def control_gaps(system, calls, ref, cfg, seed, device) -> dict:
    """Both gaps with the reference computed in float32, the precision
    below the configuration's, in the program's place."""
    th, _, best, _ = _sample(calls, cfg, seed)
    low = (ref.lnlike(system.inputs, cfg, th, device, torch.float32),
           ref.htest(system.inputs, cfg, best, device, torch.float32))
    want = (ref.lnlike(system.inputs, cfg, th, device),
            ref.htest(system.inputs, cfg, best, device))
    return {"lnlike_gap": float(np.max(np.abs(low[0] - want[0]))),
            "htest_gap": float(np.max(np.abs(low[1] - want[1])
                                      / np.abs(want[1])))}


def control(system, calls, ref, cfg, seed, device):
    """The log-likelihood gap with the reference computed in float32 in
    the program's place, and the points where float32 gives no value
    (``portbench.calibrate``'s reading; ``control_gaps`` gives both
    gaps)."""
    gap = control_gaps(system, calls, ref, cfg, seed, device)["lnlike_gap"]
    return gap, int(np.isnan(gap))
