"""One millisecond pulsar's timing fit: the TOAs made from the seed, the
port's timing model and TOA table over them, and the comparison of the
refit chi-squared values that the timed grids returned with the plain
reference.

The TOA columns (UTC and TDB epochs, the observatory's position and
velocity about the solar-system barycentre, the Sun's position) are the
benchmark's own, made by the configuration's reference module
(``simulate``), and reach the port through ``TOAs.from_npz``, the
program's loader of a processed TOA table, from memory. The port parses
the configuration's par file itself; everything else it derives in its
own set-up (the TZR TOA, DMX and JUMP masks, noise bases and weights,
the fit step).
"""

from __future__ import annotations

import gc
import io
import json

import numpy as np
import torch


class System:
    """The program under test (``model``, ``toas``), the inputs handed to
    it and to the reference (``inputs``) and the sizes the readers need
    (``dims``), and the refit steps a node takes (``maxiter``)."""

    def __init__(self, model, toas, inputs, dims, maxiter):
        self.model = model
        self.toas = toas
        self.inputs = inputs
        self.dims = dims
        self.maxiter = maxiter

    def counters(self) -> dict:
        return {}

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = self.toas = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _npz(cols) -> io.BytesIO:
    """The columns as the snapshot ``TOAs.from_npz`` reads, in memory."""
    n = len(cols["freq_mhz"])
    buf = io.BytesIO()
    np.savez(buf, mjd_day=cols["mjd_day"], mjd_frac_hi=cols["mjd_frac_hi"],
             mjd_frac_lo=cols["mjd_frac_lo"], freq_mhz=cols["freq_mhz"],
             error_us=cols["error_us"], obs=np.array(["gbt"] * n),
             names=np.array([f"toa{i}" for i in range(n)]),
             flags_json=np.array(json.dumps(cols["flags"])),
             meta_json=np.array(json.dumps({"clock_applied": True,
                                            "ephem": "analytic-kepler",
                                            "planets": False})),
             tdb_day=cols["tdb_day"], tdb_frac_hi=cols["tdb_frac_hi"],
             tdb_frac_lo=cols["tdb_frac_lo"],
             ssb_obs_pos=cols["ssb_obs_pos"],
             ssb_obs_vel=cols["ssb_obs_vel"],
             obs_sun_pos=cols["obs_sun_pos"])
    buf.seek(0)
    return buf


def build(cfg, seed, device) -> System:
    """The TOAs from the seed, and the port's model and TOA table over
    them on ``device``."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import TOAs

    from portbench import registry

    ref = registry.module("reference", cfg["name"])
    cols = ref.simulate(cfg, seed, device)
    toas = TOAs.from_npz(_npz(cols), device=device)
    par = "\n".join(ref.par_lines(cfg)) + "\n"
    model = get_model(io.StringIO(par), device=device)
    dims = {"ntoas": toas.ntoas, "nfree": len(model.free_params)}
    return System(model, toas, cols, dims, int(cfg["maxiter"]))


def _sample(calls, cfg, seed):
    """The nodes of the window's answered calls, (F0, F1) rows and chi2,
    at a sample of ``check_nodes`` drawn from the seed."""
    ok = [c for c in calls if c["ok"]]
    if not ok:
        return None
    nodes = np.concatenate([c["nodes"] for c in ok])
    got = np.concatenate([c["values"] for c in ok])
    rng = np.random.default_rng([int(seed), 0x5EED])
    pick = np.sort(rng.choice(len(got), size=min(len(got),
                                                 int(cfg["check_nodes"])),
                              replace=False))
    return nodes[pick], got[pick]


def check(system, calls, ref, cfg, seed, device):
    """{"chi2_gap": the widest gap between the refit chi2 values that the
    timed grids returned and the reference's, over a sample of the
    window's nodes drawn from the seed}; None as the value when no node
    came back."""
    s = _sample(calls, cfg, seed)
    if s is None:
        return {"chi2_gap": None}
    nodes, got = s
    want = ref.grid_chi2(system.inputs, cfg, nodes, device)
    return {"chi2_gap": float(np.max(np.abs(got - want)))}


def control(system, calls, ref, cfg, seed, device):
    """The same gap with the reference computed in float32, the precision
    below the configuration's, in the program's place: (widest gap over
    the nodes where float32 gives a value, nodes where it gives none)."""
    nodes, _ = _sample(calls, cfg, seed)
    want = ref.grid_chi2(system.inputs, cfg, nodes, device)
    low = ref.grid_chi2(system.inputs, cfg, nodes, device, torch.float32)
    gaps = np.abs(low - want)
    if np.all(np.isnan(gaps)):
        return float("nan"), len(gaps)
    return float(np.nanmax(gaps)), int(np.sum(np.isnan(gaps)))
