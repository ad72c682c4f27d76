"""Fake-TOA simulation (a port of pint_tpu/simulation.py; reference:
src/pint/simulation.py make_fake_toas_uniform, make_fake_toas_fromMJDs,
zero_residuals).

TOAs are Newton-iterated onto integer model phase (passes through the
model's phase chain, on its device), then optionally perturbed by a
white and a correlated-noise draw. The draws come from the caller's
``numpy.random.Generator`` in the reference's order, so a seed gives the
reference's noise realization.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from pint_tpu_torch.ops import dd_np
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import TOAs, get_TOAs_array

SECS_PER_DAY = 86400.0


def zero_residuals(toas: TOAs, model, maxiter: int = 4,
                   tol_s: float = 1e-10) -> TOAs:
    """Shift TOA MJDs until the model's residual phase is integer
    (reference: simulation.zero_residuals Newton loop)."""
    t = toas
    for _ in range(maxiter):
        r = Residuals(t, model, track_mode="nearest",
                      subtract_mean=False).time_resids.cpu().numpy()
        if np.max(np.abs(r)) < tol_s:
            break
        frac = dd_np.sub(t.mjd_frac,
                         dd_np.div_f(dd_np.dd(r), SECS_PER_DAY))
        t = _rebuild(t, t.mjd_day, frac)
    return t


def _rebuild(t: TOAs, day, frac) -> TOAs:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        new = get_TOAs_array((day, frac), obs=t.obs, freqs=t.freq_mhz,
                             errors=t.error_us, flags=t.flags,
                             ephem=t.ephem, planets=t.planets,
                             device=t.device)
    new.names = list(t.names)
    return new


def correlated_noise_draw(toas: TOAs, model,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """One realization [s] of the model's correlated-noise processes:
    F @ (sqrt(phi) * z), z ~ N(0, 1) per basis column."""
    rng = rng or np.random.default_rng()
    F = model.noise_model_designmatrix(toas)
    if F is None:
        return np.zeros(toas.ntoas)
    phi = model.noise_model_basis_weight(toas)
    return F @ (np.sqrt(phi) * rng.standard_normal(F.shape[1]))


def _noise_draw_s(t: TOAs, model, rng, white: bool,
                  correlated: bool) -> np.ndarray:
    """Noise draw [s]: white at the EFAC/EQUAD-scaled sigma when
    ``white``, plus a correlated-basis draw when ``correlated``."""
    noise_s = np.zeros(t.ntoas)
    if white:
        sigma = model.scaled_toa_uncertainty(t) if model.noise_components \
            else t.error_us * 1e-6
        noise_s = rng.standard_normal(t.ntoas) * sigma
    if correlated:
        noise_s = noise_s + correlated_noise_draw(t, model, rng)
    return noise_s


def make_fake_toas_uniform(startMJD: float, endMJD: float, ntoas: int,
                           model, error_us: float = 1.0, obs: str = "gbt",
                           freq_mhz: float = 1400.0, add_noise: bool = False,
                           add_correlated_noise: bool = False,
                           rng: Optional[np.random.Generator] = None,
                           name: str = "fake", flags=None,
                           device=None) -> TOAs:
    """Evenly spaced synthetic TOAs landing on integer model phase
    (reference: make_fake_toas_uniform)."""
    return make_fake_toas_fromMJDs(
        np.linspace(float(startMJD), float(endMJD), int(ntoas)), model,
        error_us=error_us, obs=obs, freq_mhz=freq_mhz,
        add_noise=add_noise, add_correlated_noise=add_correlated_noise,
        rng=rng, name=name, flags=flags, device=device)


def make_fake_toas_fromMJDs(mjds, model, error_us=1.0, obs: str = "gbt",
                            freq_mhz=1400.0, add_noise: bool = False,
                            add_correlated_noise: bool = False,
                            rng: Optional[np.random.Generator] = None,
                            name: str = "fake", flags=None,
                            device=None) -> TOAs:
    """Synthetic TOAs at the given MJDs, landing on integer model phase
    (reference: make_fake_toas_fromMJDs). ``freq_mhz``/``error_us`` may
    be scalars or per-TOA arrays; ``flags`` per-TOA dicts (or one dict
    for all), set here so flag-selected noise applies to the draw.
    ``device`` (the model's when None) is where the TOAs' batch goes."""
    mjds = np.atleast_1d(np.asarray(mjds, dtype=np.float64))
    if isinstance(flags, dict):
        flags = [dict(flags) for _ in range(mjds.shape[0])]
    elif flags is not None and len(flags) != mjds.shape[0]:
        raise ValueError(
            f"flags has {len(flags)} entries for {mjds.shape[0]} "
            f"TOAs (pass one dict to apply the same flags to all)")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = get_TOAs_array(
            mjds, obs=obs, freqs=freq_mhz, errors=error_us,
            ephem=model.EPHEM.value, flags=flags,
            planets=bool(model.PLANET_SHAPIRO.value),
            device=model.device if device is None else device)
    t.names = [f"{name}{i}" for i in range(t.ntoas)]
    t = zero_residuals(t, model)
    if add_noise or add_correlated_noise:
        rng = rng or np.random.default_rng()
        noise_s = _noise_draw_s(t, model, rng, add_noise,
                                add_correlated_noise)
        frac = dd_np.add(t.mjd_frac,
                         dd_np.div_f(dd_np.dd(noise_s), SECS_PER_DAY))
        t = _rebuild(t, t.mjd_day, frac)
    return t
