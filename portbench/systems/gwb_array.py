"""A pulsar timing array's GWB likelihood: the inputs made from the seed,
the port's ``GWBLikelihood`` built over them, and the comparison of what
the timed calls returned with the plain reference.

Each pulsar's linearized problem (TOA epochs, design, white-noise
variances, intrinsic red-noise basis and weights, residuals) and its sky
position are drawn on the device from the seed in a few large calls, in
float64. The residuals carry white noise, the pulsar's own red noise and
a Hellings-Downs correlated common process at the configuration's
amplitude and spectral index. The sizes are the configuration's and do
not depend on the seed.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

YEAR_D = 365.25
BASE_COLUMNS = 9  # offset, t, t^2, six astrometric terms


class System:
    """The program under test (``like``), the inputs handed to it and to
    the reference (``inputs``) and the sizes the readers need (``dims``)."""

    def __init__(self, like, inputs, dims):
        self.like = like
        self.inputs = inputs
        self.dims = dims

    def counters(self) -> dict:
        return self.like.metrics.snapshot()

    def release(self):
        """Free the program's state before the reference runs."""
        self.like = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _epochs(cfg, g, device):
    """Per pulsar: TOA times [MJD], radio frequencies [MHz] and each TOA's
    epoch index."""
    a = cfg["assumed"]
    P = cfg["npulsars"]
    per = int(a["toas_per_epoch"])
    nep = [int(n) // per for n in a["toas"][:P]]
    jitter = torch.rand(sum(nep), generator=g, device=device,
                        dtype=torch.float64)
    (lo1, hi1), (lo2, hi2) = a["bands_mhz"]
    half = per // 2
    sub = torch.arange(per, device=device, dtype=torch.float64)
    band = (sub >= half).to(torch.float64)
    k = sub - band * half
    freq_one = torch.where(band > 0, lo2 + (k + 0.5) / half * (hi2 - lo2),
                           lo1 + (k + 0.5) / half * (hi1 - lo1))
    # the two receivers 0.02 d apart, sub-bands 1e-5 d apart
    dt_one = band * 0.02 + k * 1e-5
    out, o = [], 0
    for p in range(P):
        cad = float(a["cadence_days"][p])
        start = float(a["end_mjd"]) - nep[p] * cad
        ep = start + (torch.arange(nep[p], device=device,
                                   dtype=torch.float64) + 0.5
                      + 0.6 * (jitter[o:o + nep[p]] - 0.5)) * cad
        o += nep[p]
        t = (ep[:, None] + dt_one[None, :]).reshape(-1)
        f = freq_one.repeat(nep[p])
        idx = torch.arange(nep[p], device=device).repeat_interleave(per)
        out.append((t, f, idx))
    return out


def _design(t, f, idx, nep, ncols):
    """Offset, spin and astrometric columns, then DMX windows over
    consecutive epochs, scaled to microseconds."""
    mid = 0.5 * (t.max() + t.min())
    half = 0.5 * (t.max() - t.min())
    tn = (t - mid) / half
    w = 2.0 * math.pi * t / YEAR_D
    cols = [torch.ones_like(t), tn, tn * tn, torch.sin(w), torch.cos(w),
            tn * torch.sin(w), tn * torch.cos(w), torch.sin(2 * w),
            torch.cos(2 * w)]
    ndmx = ncols - BASE_COLUMNS
    win = (idx * ndmx) // nep
    dmx = torch.nn.functional.one_hot(win, ndmx).to(t.dtype) \
        * ((1400.0 / f) ** 2)[:, None]
    return torch.cat([torch.stack(cols, dim=1), dmx], dim=1) * 1e-6


def make_inputs(cfg, seed, device):
    """The array's inputs as host arrays: per-pulsar lists under
    mjd_day, mjd_frac_hi, mjd_frac_lo, freq_mhz, error_us, M, F, phi, r,
    nvec, and positions (P, 3) and nfreq."""
    from portbench import registry

    ref = registry.module("reference", cfg["name"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    a = cfg["assumed"]
    P = cfg["npulsars"]
    nrn = int(cfg["red_noise_modes"])
    nfreq = int(cfg["gwb_nfreq"])
    f64 = dict(device=device, dtype=torch.float64)
    ep = _epochs(cfg, g, device)
    ntot = sum(len(t) for t, _, _ in ep)
    # a few large draws, split by pulsar below
    u = torch.rand(P, 3, generator=g, **f64)
    pos = torch.randn(P, 3, generator=g, **f64)
    pos = pos / torch.linalg.norm(pos, dim=1, keepdim=True)
    scatter = torch.rand(ntot, generator=g, **f64)
    white = torch.randn(ntot, generator=g, **f64)
    rn = torch.randn(P, 2 * nrn, generator=g, **f64)
    common = torch.randn(P, 2 * nfreq, generator=g, **f64)

    def span(lohi, v):
        return lohi[0] + (lohi[1] - lohi[0]) * v

    wlo, whi = (math.log(x) for x in a["white_noise_us"])
    sigma_us = torch.exp(wlo + (whi - wlo) * u[:, 0])
    rn_la = span(a["red_noise_log10_A"], u[:, 1])
    rn_ga = span(a["red_noise_gamma"], u[:, 2])
    # the common process: coefficients with covariance Gamma (x) diag(phi)
    day = [torch.floor(t) for t, _, _ in ep]
    frac = [t - d for (t, _, _), d in zip(ep, day)]
    host = {"mjd_day": [d.cpu().numpy() for d in day],
            "mjd_frac_hi": [fr.cpu().numpy() for fr in frac],
            "mjd_frac_lo": [np.zeros(len(d)) for d in day]}
    ts, tspan = ref.epoch_seconds(host)
    Gamma = ref.hellings_downs(pos)
    fc = torch.arange(1, nfreq + 1, **f64).repeat_interleave(2) / tspan
    phi_c = ref.powerlaw_weights(fc, cfg["gwb_log10_A"], cfg["gwb_gamma"],
                                 tspan)
    coef = (torch.linalg.cholesky(Gamma) @ common) * torch.sqrt(phi_c)
    out = dict(host, freq_mhz=[], error_us=[], M=[], F=[], phi=[], r=[],
               nvec=[])
    o = 0
    for p, (t, f, idx) in enumerate(ep):
        n = len(t)
        err = sigma_us[p] * (0.7 + 0.8 * scatter[o:o + n])
        tsec = torch.as_tensor(ts[p], **f64)
        own = tsec - tsec.min()
        Tp = float(own.max())
        F, fr = ref.fourier_basis(own, nrn, Tp)
        phi = ref.powerlaw_weights(fr, float(rn_la[p]), float(rn_ga[p]), Tp)
        U, _ = ref.fourier_basis(tsec, nfreq, tspan)
        r = err * 1e-6 * white[o:o + n] + F @ (torch.sqrt(phi) * rn[p]) \
            + U @ coef[p]
        M = _design(t, f, idx, n // int(a["toas_per_epoch"]),
                    int(a["design_columns"][p]))
        o += n
        for key, v in (("freq_mhz", f), ("error_us", err), ("M", M),
                       ("F", F), ("phi", phi), ("r", r),
                       ("nvec", (err * 1e-6) ** 2)):
            out[key].append(v.cpu().numpy())
    out["positions"] = pos.cpu().numpy()
    out["nfreq"] = nfreq
    return out


def build(cfg, seed, device) -> System:
    """The inputs from the seed and the port's likelihood over them, its
    per-pulsar blocks assembled (set-up, as a sweep's caller does)."""
    from pint_tpu_torch.parallel.pta import PulsarProblem
    from pint_tpu_torch.pta import GWBLikelihood
    from pint_tpu_torch.toa import get_TOAs_array

    inputs = make_inputs(cfg, seed, device)
    problems = []
    for p in range(cfg["npulsars"]):
        toas = get_TOAs_array(
            (inputs["mjd_day"][p], (inputs["mjd_frac_hi"][p],
                                    inputs["mjd_frac_lo"][p])),
            obs="barycenter", freqs=inputs["freq_mhz"][p],
            errors=inputs["error_us"][p], device=device)
        names = ["Offset"] + [f"c{j}" for j in
                              range(1, inputs["M"][p].shape[1])]
        problems.append(PulsarProblem(
            inputs["M"][p], inputs["r"][p], inputs["nvec"][p],
            inputs["F"][p], inputs["phi"][p], names, toas=toas))
    like = GWBLikelihood(problems=problems, positions=inputs["positions"],
                         nfreq=inputs["nfreq"], device=device)
    like.build_blocks()
    dims = {"npulsars": like.npulsars, "m": like.m}
    return System(like, inputs, dims)


def _sample(calls, cfg, seed):
    """The points of the window's answered calls, (log10 A, gamma, value),
    at a sample of ``check_points`` drawn from the seed."""
    ok = [c for c in calls if c["ok"]]
    if not ok:
        return None
    la, ga, got = (np.concatenate([c[k] for c in ok])
                   for k in ("log10_A", "gamma", "values"))
    rng = np.random.default_rng([int(seed), 0x5EED])
    pick = np.sort(rng.choice(len(got), size=min(len(got),
                                                 int(cfg["check_points"])),
                              replace=False))
    return la[pick], ga[pick], got[pick]


def check(system, calls, ref, cfg, seed, device):
    """{"loglik_gap": the widest gap [nats] between the log-likelihoods
    the timed calls returned and the reference's, over a sample of the
    window's points drawn from the seed}; None as the value when no point
    came back."""
    s = _sample(calls, cfg, seed)
    if s is None:
        return {"loglik_gap": None}
    la, ga, got = s
    want = ref.loglik(ref.prepare(system.inputs, device), la, ga)
    return {"loglik_gap": float(np.max(np.abs(got - want)))}


def control(system, calls, ref, cfg, seed, device):
    """The same gap with the reference computed in float32, the precision
    below the configuration's, in the program's place: (widest gap over
    the points where float32 gives a value, points where it gives none).
    """
    la, ga, _ = _sample(calls, cfg, seed)
    want = ref.loglik(ref.prepare(system.inputs, device), la, ga)
    low = ref.loglik(ref.prepare(system.inputs, device, torch.float32),
                     la, ga)
    gaps = np.abs(low - want)
    return float(np.nanmax(gaps)), int(np.sum(np.isnan(gaps)))
