"""Fake-TOA simulation (a port of pint_tpu/simulation.py; reference:
src/pint/simulation.py make_fake_toas_uniform, make_fake_toas_fromMJDs,
make_fake_toas_fromtim, zero_residuals, calculate_random_models).

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
import torch

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


def make_fake_toas_fromtim(timfile, model, add_noise=False,
                           add_correlated_noise=False, rng=None,
                           device=None) -> TOAs:
    """Replace the TOAs of an existing tim file with model-aligned fakes
    (reference: make_fake_toas_fromtim). ``device`` (the model's when
    None) is where the TOAs' batch goes."""
    from pint_tpu_torch.toa import get_TOAs

    t = get_TOAs(timfile, model=model,
                 device=model.device if device is None else device)
    t = zero_residuals(t, model)
    if add_noise or add_correlated_noise:
        rng = rng or np.random.default_rng()
        noise_s = _noise_draw_s(t, model, rng, add_noise,
                                add_correlated_noise)
        frac = dd_np.add(t.mjd_frac,
                         dd_np.div_f(dd_np.dd(noise_s), SECS_PER_DAY))
        t = _rebuild(t, t.mjd_day, frac)
    return t


def calculate_random_models(fitter, toas, Nmodels: int = 100,
                            rng: Optional[np.random.Generator] = None
                            ) -> torch.Tensor:
    """Draw parameter vectors from the post-fit covariance and return the
    residual curve [s] of each draw (reference:
    simulation.calculate_random_models), as a (Nmodels, ntoa) float64
    TENSOR on the fitter's device, like Residuals.time_resids (the
    reference returns numpy).

    The draws come from ``rng`` as the reference takes them; each draw
    is added to the fitted values in dd, as Parameter.add_delta does.
    The residuals are those of Residuals(toas, drawn model,
    subtract_mean=False), for all draws in one ``torch.func.vmap`` of
    the model's phase function over the drawn parameter vectors (the
    reference evaluates a deep copy of the model per draw)."""
    from pint_tpu_torch.phase import Phase
    from pint_tpu_torch.residuals import padd_turns, tracked_phase

    rng = rng or np.random.default_rng()
    model = fitter.model
    cov = fitter.parameter_covariance_matrix
    if cov is None:
        raise ValueError("fit first: no covariance available")
    names = list(model.free_params)
    # the covariance includes the Offset column when fitted with one
    full_names = ["Offset"] + names if cov.shape[0] == len(names) + 1 \
        else names
    draws = rng.multivariate_normal(np.zeros(cov.shape[0]), cov,
                                    size=Nmodels)
    free, _, th, tl, fh, fl = model._pack()
    th_k = np.repeat(np.asarray(th, np.float64)[None], Nmodels, axis=0)
    tl_k = np.repeat(np.asarray(tl, np.float64)[None], Nmodels, axis=0)
    for c, name in enumerate(full_names):
        if name == "Offset":
            continue
        j = free.index(name)
        th_k[:, j], tl_k[:, j] = dd_np.add_f((th_k[:, j], tl_k[:, j]),
                                             draws[:, c])
    # each draw's residuals are divided by its own F0 value (hi + lo)
    i_f0 = free.index("F0") if "F0" in free else None
    f0 = th_k[:, i_f0] + tl_k[:, i_f0] if i_f0 is not None \
        else np.full(Nmodels, float(model.F0.value))

    dev = fitter.device
    cache = model.get_cache(toas, dev)
    phase_fn, _ = model._build_phase_fn()

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    fh_t, fl_t = tensor(fh), tensor(fl)
    # Residuals' default track mode: the pulse numbers when the TOAs
    # carry them
    pn = toas.get_pulse_numbers()
    pn_t = None if pn is None else tensor(pn)
    padd_t = padd_turns(toas, dev)

    def resid_phase(th_row, tl_row):
        ph, _ = phase_fn(th_row, tl_row, fh_t, fl_t, cache["batch"],
                         cache)
        return tracked_phase(Phase(ph), pn_t, padd_t)

    phases = torch.func.vmap(resid_phase)(tensor(th_k), tensor(tl_k))
    return phases / tensor(f0)[:, None]
