"""Energy-dependent pulse-profile templates (a port of
pint_tpu/templates/energy.py; reference: src/pint/templates/
lceprimitives.py + lcenorms.py).

ONE flat theta holds the base template parameters plus d(param)/dx
slopes in x = log10(E/E0), and the pdf evaluates every photon's (phase,
energy) pair in one pass of torch float64 ops on the photons' device:

    logits_e = logits + x * dlogits     -> softmax_e (per photon)
    loc_k(E) = loc_k + x * dloc_k
    w_k(E)   = exp(log w_k + x * dlogw_k)
    f(phi, E) = p0(E) + sum_k p_k(E) prim_k(phi; loc_k(E), w_k(E))

Each primitive pdf is normalized for every width, and the softmax
normalizations sum to 1 at every energy, so f(.|E) is a proper
conditional density.

theta layout (m primitives, all single-shape):
    [logits (m+1) | locs (m) | log_w (m) | dlogits (m+1) | dloc (m) |
     dlogw (m)]
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import config, resolve_device
from pint_tpu_torch.templates import (LCGaussian, LCLorentzian, LCTemplate,
                                      LCVonMises, _converged, _f64, _images,
                                      _minimize, _value_and_grad)

__all__ = ["LCEnergyTemplate", "LCEnergyFitter"]

_E_PRIMS = (LCGaussian, LCVonMises, LCLorentzian)
_DRAW_GRID = 2048     # random's inverse-cdf grid cells


def _prim_pdf_vec(prim, phi, loc, width):
    """Primitive pdf with PER-PHOTON loc/width tensors. The von Mises
    and Lorentzian base pdfs are purely elementwise and broadcast
    per-photon shapes as-is; only the Gaussian needs a variant — its
    base pdf's wrapped-copies axis assumes a scalar width."""
    if isinstance(prim, LCGaussian):
        z = (phi[:, None] - loc[:, None] + _images(phi)[None, :]) \
            / width[:, None]
        return torch.sum(torch.exp(-0.5 * z * z), dim=-1) / (
            width * math.sqrt(2 * math.pi))
    return prim.pdf(phi, loc, (width,))


class LCEnergyTemplate:
    """Template whose normalizations, peak locations, and widths vary
    linearly in x = log10(E/E0) (reference: lceprimitives' 'slope'
    parameterization). ``device`` (None means "cuda") is where
    ``__call__`` and ``random`` evaluate the pdf."""

    def __init__(self, template: LCTemplate, e0_kev: float = 1.0,
                 dlogits=None, dloc=None, dlogw=None, device=None):
        for p in template.primitives:
            if not isinstance(p, _E_PRIMS):
                raise ValueError(
                    f"energy-dependent templates support "
                    f"{[c.name for c in _E_PRIMS]}; got {p.name}")
        self.device = resolve_device(device)
        self.primitives = list(template.primitives)
        m = len(self.primitives)
        self.e0_kev = float(e0_kev)
        base = np.asarray(template.theta, dtype=np.float64)

        def slopes(v, n, name):
            if v is None:
                return np.zeros(n)
            v = np.asarray(v, dtype=np.float64)
            if v.shape != (n,):
                raise ValueError(
                    f"{name} needs shape ({n},), got {v.shape} — a "
                    "wrong length would silently shift every slope "
                    "slice in theta")
            return v

        self.theta = np.concatenate([
            base,
            slopes(dlogits, m + 1, "dlogits"),
            slopes(dloc, m, "dloc"),
            slopes(dlogw, m, "dlogw")])

    @property
    def m(self) -> int:
        return len(self.primitives)

    def _pdf_fn(self):
        """pdf(theta, phi, energy_kev) on the device of the photons."""
        prims = list(self.primitives)
        m = len(prims)
        e0 = self.e0_kev

        def pdf(theta, phi, energy_kev):
            x = torch.log10(energy_kev / e0)
            logits = theta[:m + 1]
            locs = theta[m + 1:2 * m + 1]
            logw = theta[2 * m + 1:3 * m + 1]
            dlogits = theta[3 * m + 1:4 * m + 2]
            dloc = theta[4 * m + 2:5 * m + 2]
            dlogw = theta[5 * m + 2:6 * m + 2]
            p = torch.softmax(logits[None, :]
                              + x[:, None] * dlogits[None, :],
                              dim=-1)              # (N, m+1)
            val = p[:, 0]
            for k, prim in enumerate(prims):
                loc_e = locs[k] + x * dloc[k]
                w_e = torch.exp(logw[k] + x * dlogw[k])
                val = val + p[:, k + 1] * _prim_pdf_vec(
                    prim, phi, loc_e, w_e)
            return val

        return pdf

    def __call__(self, phases, energies_kev, theta=None) -> np.ndarray:
        theta = self.theta if theta is None else theta
        dev = self.device
        return self._pdf_fn()(_f64(theta, dev), _f64(phases, dev),
                              _f64(energies_kev, dev)).cpu().numpy()

    def base_template(self) -> LCTemplate:
        """The energy-independent template at E = E0, on this
        template's device."""
        m = self.m
        t = LCTemplate.__new__(LCTemplate)
        t.device = self.device
        t.primitives = list(self.primitives)
        t._shape_sizes = [1] * m
        t.theta = np.asarray(self.theta[:3 * m + 1]).copy()
        return t

    def random(self, n: int, energies_kev,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Draw photon phases given per-photon energies (inverse cdf on
        a grid of 2,048 cells; reference: LCEnergyTemplate.random). The
        (n, 2048) pdf matrix is evaluated on the device in photon chunks
        of ``config.energy_draw_chunk`` rows; each row's cdf and draw
        read only that row, so the draws do not depend on the chunk."""
        rng = rng or np.random.default_rng()
        energies_kev = np.asarray(energies_kev, dtype=np.float64)
        if energies_kev.shape != (n,):
            raise ValueError(
                f"energies_kev must have shape ({n},) matching n; "
                f"got {energies_kev.shape}")
        grid = np.linspace(0.0, 1.0, _DRAW_GRID + 1)
        centers = 0.5 * (grid[:-1] + grid[1:])
        u = rng.uniform(size=n)
        dev = self.device
        pdf = self._pdf_fn()
        theta = _f64(self.theta, dev)
        cj = _f64(centers, dev)
        idx = np.empty(n, dtype=np.int64)
        step = config.energy_draw_chunk(_DRAW_GRID)
        for a in range(0, n, step):
            e = _f64(energies_kev[a:a + step], dev)
            rows = e.shape[0]
            vals = pdf(theta, cj.repeat(rows),
                       e.repeat_interleave(_DRAW_GRID))
            cdf = torch.cumsum(vals.reshape(rows, _DRAW_GRID), dim=1)
            cdf = cdf / cdf[:, -1:]
            # per-row inverse cdf without a python loop: rows are monotone
            below = cdf < _f64(u[a:a + step], dev)[:, None]
            idx[a:a + rows] = torch.sum(below, dim=1).cpu().numpy()
        return centers[np.clip(idx, 0, len(centers) - 1)]

    def __str__(self):
        m = self.m
        lines = [f"LCEnergyTemplate (E0 = {self.e0_kev} keV)"]
        lines.append(str(self.base_template()))
        lines.append("slopes per decade of energy:")
        lines.append(f"  dloc  {np.round(self.theta[4*m+2:5*m+2], 4)}")
        lines.append(f"  dlogw {np.round(self.theta[5*m+2:6*m+2], 4)}")
        return "\n".join(lines)


class LCEnergyFitter:
    """Unbinned weighted ML over (phase, energy) photon pairs
    (reference: lcfitters with energy-dependent primitives), on
    ``device`` (None means "cuda")."""

    def __init__(self, template: LCEnergyTemplate, phases,
                 energies_kev, weights=None, device=None):
        self.template = template
        self.device = dev = resolve_device(device)
        self.phases = torch.remainder(
            torch.as_tensor(phases, dtype=torch.float64, device=dev), 1.0)
        self.energies = torch.as_tensor(energies_kev, dtype=torch.float64,
                                        device=dev)
        self.weights = (torch.ones_like(self.phases) if weights is None
                        else torch.as_tensor(weights, dtype=torch.float64,
                                             device=dev))
        pdf = template._pdf_fn()
        ph, en, w = self.phases, self.energies, self.weights
        wc = 1.0 - w

        def nll(theta):
            f = pdf(theta, ph, en)
            return -torch.sum(torch.log(w * f + wc))

        self._nll = nll
        self._valgrad = torch.func.grad_and_value(nll)

    def loglikelihood(self, theta=None) -> float:
        theta = self.template.theta if theta is None else theta
        return -float(self._nll(_f64(theta, self.device)))

    def fit(self, maxiter: int = 500) -> dict:
        dev = self.device
        res = _minimize(lambda x: _value_and_grad(self._valgrad,
                                                  _f64(x, dev)),
                        np.asarray(self.template.theta), maxiter)
        self.template.theta = np.asarray(res.x)
        ok, gnorm = _converged(res)
        return {"loglikelihood": -float(res.fun),
                "iterations": int(res.nit),
                "grad_norm": gnorm,
                "success": ok}
