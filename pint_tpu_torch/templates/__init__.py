"""Photon pulse-profile templates and maximum-likelihood fitting (a port
of pint_tpu/templates/__init__.py; reference: src/pint/templates/
lcprimitives.py, lctemplate.py, lcfitters.py).

A template is a pure function of one flat float64 parameter vector:

    theta = [logits (m+1,) | locs (m,) | log_shapes (sum n_shape,)]

softmax(logits) -> [background, norm_1..norm_m]; shape parameters
(widths) live in log space so they stay positive. The pdf
(``LCTemplate._pdf_fn``) is a function of ``(theta, phi)`` torch tensors
that runs on the device of the phases it is given and maps under
``torch.func.vmap`` over either argument. ``LCFitter`` drives scipy's
BFGS from the host over the device value and gradient of the unbinned
weighted photon log-likelihood (``torch.func.grad_and_value``), and takes
its errors from the exact autodiff Hessian (``torch.func.hessian``).

``LCTemplate`` holds ``theta`` as a numpy array on the host and
evaluates ``__call__`` on its ``device`` (None means "cuda"). The
properties (norms, locs, widths) and ``random``'s draws are host values,
the same on every device. Template files are the reference's format:
a file either package writes reads back in the other.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_tpu_torch import resolve_device

__all__ = ["LCPrimitive", "LCGaussian", "LCGaussian2", "LCVonMises",
           "LCLorentzian", "LCLorentzian2", "LCTopHat",
           "LCSkewGaussian", "LCEmpiricalFourier", "LCKernelDensity",
           "LCTemplate", "LCFitter", "GaussianPrior",
           "read_template", "write_template", "make_template"]

SQRT_2PI = math.sqrt(2 * math.pi)


def _images(phi: torch.Tensor) -> torch.Tensor:
    """The 7 wrapped-image offsets ns = -3..3 on the device of ``phi``."""
    return torch.arange(-3.0, 4.0, dtype=torch.float64, device=phi.device)


class LCPrimitive:
    """One peak shape: a normalized pdf on phase [0,1) with a location
    and ``n_shape`` positive shape parameters (reference:
    lcprimitives.LCPrimitive)."""

    name = "prim"
    n_shape = 1

    @staticmethod
    def pdf(phi, loc, shape):  # pragma: no cover - abstract
        """shape is a (n_shape,) slice of exp(log_shapes)."""
        raise NotImplementedError

    @classmethod
    def fwhm(cls, shape) -> float:
        """Full width at half max in phase units (reference:
        LCPrimitive.fwhm); default assumes shape[0] is a Gaussian-like
        sigma."""
        return float(2.0 * math.sqrt(2.0 * math.log(2.0)) * shape[0])


class LCGaussian(LCPrimitive):
    """Wrapped Gaussian peak (reference: lcprimitives.LCGaussian).
    shape[0] = sigma in phase units; wrapping summed over +-3 turns."""

    name = "gaussian"

    @staticmethod
    def pdf(phi, loc, shape):
        width = shape[0]
        d = phi - loc
        z = (d[..., None] + _images(phi)) / width
        g = torch.exp(-0.5 * z * z)
        return torch.sum(g, dim=-1) / (width * SQRT_2PI)


class LCGaussian2(LCPrimitive):
    """Two-sided (asymmetric) wrapped Gaussian: sigma_left below the
    peak, sigma_right above, continuous at the peak with overall unit
    normalization 2/(sl+sr) scaling (reference:
    lcprimitives.LCGaussian2)."""

    name = "gaussian2"
    n_shape = 2

    @staticmethod
    def pdf(phi, loc, shape):
        sl, sr = shape[0], shape[1]
        d = phi - loc
        dn = d[..., None] + _images(phi)
        sig = torch.where(dn < 0, sl, sr)
        g = torch.exp(-0.5 * (dn / sig) ** 2)
        norm = SQRT_2PI * 0.5 * (sl + sr)
        return torch.sum(g, dim=-1) / norm

    @classmethod
    def fwhm(cls, shape) -> float:
        k = 2.0 * math.sqrt(2.0 * math.log(2.0))
        return float(0.5 * k * (shape[0] + shape[1]))


class LCVonMises(LCPrimitive):
    """Von Mises peak: exp(kappa cos 2pi(phi-loc)) / I0(kappa), with
    kappa = 1/(2 pi width)^2 matching the reference's width convention
    (reference: lcprimitives.LCVonMises)."""

    name = "vonmises"

    @staticmethod
    def pdf(phi, loc, shape):
        width = shape[0]
        kappa = 1.0 / (2.0 * math.pi * width) ** 2
        val = torch.exp(kappa * (torch.cos(2 * math.pi * (phi - loc)) - 1.0))
        norm = torch.special.i0e(kappa)  # e^-k I0(k): overflow-safe
        return val / norm


class LCLorentzian(LCPrimitive):
    """Wrapped Lorentzian (wrapped-Cauchy closed form), width = HWHM in
    phase units (reference: lcprimitives.LCLorentzian)."""

    name = "lorentzian"

    @staticmethod
    def pdf(phi, loc, shape):
        width = shape[0]
        rho = torch.exp(-2.0 * math.pi * width)
        c = torch.cos(2.0 * math.pi * (phi - loc))
        return (1.0 - rho ** 2) / (1.0 + rho ** 2 - 2.0 * rho * c)

    @classmethod
    def fwhm(cls, shape) -> float:
        return float(2.0 * shape[0])


class LCLorentzian2(LCPrimitive):
    """Two-sided wrapped Lorentzian: HWHM gamma_left below the peak,
    gamma_right above (reference: lcprimitives.LCLorentzian2). Built
    from two half wrapped-Cauchy lobes, each lobe weighted so the
    composite is continuous at the peak and integrates to 1."""

    name = "lorentzian2"
    n_shape = 2

    @staticmethod
    def pdf(phi, loc, shape):
        gl, gr = shape[0], shape[1]

        def half(width, c):
            rho = torch.exp(-2.0 * math.pi * width)
            val = (1.0 - rho ** 2) / (1.0 + rho ** 2 - 2.0 * rho * c)
            peak = (1.0 + rho) / (1.0 - rho)   # value at phase == loc
            return val, peak

        # signed phase distance in (-0.5, 0.5]
        d = torch.remainder(phi - loc + 0.5, 1.0) - 0.5
        c = torch.cos(2.0 * math.pi * d)
        vl, pl = half(gl, c)
        vr, pr = half(gr, c)
        # scale each lobe to a common peak height, then normalize:
        # each full wrapped-Cauchy integrates to 1, so each half-lobe
        # (scaled by s) integrates to s/2.
        sl = 1.0 / pl
        sr = 1.0 / pr
        val = torch.where(d < 0, sl * vl, sr * vr)
        return val / (0.5 * (sl + sr))

    @classmethod
    def fwhm(cls, shape) -> float:
        return float(shape[0] + shape[1])


class LCTopHat(LCPrimitive):
    """Smoothed top hat: product of two logistic edges of 1% of the
    width, full width = shape[0] in phase (reference:
    lcprimitives.LCTopHat — exact box there; smoothed here so the ML
    fit stays differentiable)."""

    name = "tophat"

    @staticmethod
    def pdf(phi, loc, shape):
        width = shape[0]
        k = 100.0 / width  # edge sharpness: 1% of the width
        d = torch.remainder(phi - loc + 0.5, 1.0) - 0.5
        box = torch.sigmoid(k * (d + width / 2)) * \
            torch.sigmoid(-k * (d - width / 2))
        # normalization of the product of sigmoids ~ width for k*w >> 1
        return box / width

    @classmethod
    def fwhm(cls, shape) -> float:
        return float(shape[0])


class LCSkewGaussian(LCPrimitive):
    """Wrapped skew-normal peak (reference: the lcprimitives skew
    family): pdf = 2/sigma phi(z) Phi(alpha z), z = d/sigma. Shape
    params ride the template's log transform (positive), so the SIGNED
    skewness alpha is stored as shape[1] = exp(alpha): shape[1] = 1 is
    symmetric, >1 skews the tail to later phase, <1 to earlier."""

    name = "skewgaussian"
    n_shape = 2

    @staticmethod
    def pdf(phi, loc, shape):
        sigma = shape[0]
        alpha = torch.log(shape[1])
        d = phi - loc
        z = (d[..., None] + _images(phi)) / sigma
        g = torch.exp(-0.5 * z * z) / (sigma * SQRT_2PI)
        cdf = 0.5 * (1.0 + torch.special.erf(alpha * z / math.sqrt(2.0)))
        return torch.sum(2.0 * g * cdf, dim=-1)

    @classmethod
    def fwhm(cls, shape) -> float:
        # Gaussian-equivalent width of the skew-normal
        a = math.log(float(shape[1]))
        dlt = a / math.sqrt(1 + a * a)
        sd = float(shape[0]) * math.sqrt(1 - 2 * dlt * dlt / math.pi)
        return 2.0 * math.sqrt(2.0 * math.log(2.0)) * sd


_PRIM_TYPES = {c.name: c for c in
               (LCGaussian, LCGaussian2, LCVonMises, LCLorentzian,
                LCLorentzian2, LCTopHat, LCSkewGaussian)}


class LCEmpiricalFourier:
    """Empirical template as a truncated Fourier series measured from
    photon phases (reference: lcprimitives/lctemplate empirical
    Fourier machinery): pdf(phi) = max(1 + Σ_k a_k cos 2πkφ +
    b_k sin 2πkφ, eps), renormalized after the positivity clip.
    A fixed (measured, not ML-fit) profile for phase-folding /
    weighted-H workflows; use LCTemplate+LCFitter for parametric
    fits. Host numpy, as in the reference."""

    def __init__(self, coeffs_cos, coeffs_sin):
        self.a = np.asarray(coeffs_cos, np.float64)
        self.b = np.asarray(coeffs_sin, np.float64)
        if self.a.shape != self.b.shape:
            raise ValueError("cos/sin coefficient shapes differ")
        self._norm = self._compute_norm()

    @classmethod
    def from_phases(cls, phases, weights=None, nharm: int = 20):
        """Measure the harmonic coefficients from (weighted) photon
        phases: a_k = 2<w cos 2πkφ>/<w>, b_k likewise (the empirical
        characteristic function)."""
        ph = np.mod(np.asarray(phases, np.float64), 1.0)
        w = np.ones_like(ph) if weights is None else \
            np.asarray(weights, np.float64)
        k = np.arange(1, nharm + 1)
        arg = 2 * np.pi * ph[:, None] * k[None, :]
        wsum = w.sum()
        a = 2.0 * (w[:, None] * np.cos(arg)).sum(0) / wsum
        b = 2.0 * (w[:, None] * np.sin(arg)).sum(0) / wsum
        return cls(a, b)

    def _raw(self, phi):
        phi = np.mod(np.asarray(phi, np.float64), 1.0)
        k = np.arange(1, len(self.a) + 1)
        arg = 2 * np.pi * phi[..., None] * k
        return (1.0 + (self.a * np.cos(arg)).sum(-1)
                + (self.b * np.sin(arg)).sum(-1))

    def _compute_norm(self) -> float:
        xs = np.linspace(0.0, 1.0, 4096, endpoint=False)
        return float(np.mean(np.maximum(self._raw(xs), 1e-6)))

    def __call__(self, phases) -> np.ndarray:
        return np.maximum(self._raw(phases), 1e-6) / self._norm


class LCKernelDensity:
    """Empirical template as a wrapped-Gaussian kernel density of the
    photon phases (reference: lcprimitives.LCKernelDensity). Bandwidth
    defaults to the circular Silverman rule; evaluation is gridded +
    interpolated so calling with millions of photons stays cheap. Host
    numpy, as in the reference."""

    def __init__(self, phases, weights=None, bw: float = None,
                 ngrid: int = 1024):
        ph = np.mod(np.asarray(phases, np.float64), 1.0)
        w = np.ones_like(ph) if weights is None else \
            np.asarray(weights, np.float64)
        if bw is None:
            # circular dispersion -> Silverman-style bandwidth, scaled
            # DOWN 3x: pulse profiles are multimodal (narrow peaks on
            # a broad background), where the global Silverman rule
            # oversmooths by roughly the peak width; pass bw= to
            # control it exactly
            C = np.average(np.cos(2 * np.pi * ph), weights=w)
            S = np.average(np.sin(2 * np.pi * ph), weights=w)
            R = np.hypot(C, S)
            sigma_c = np.sqrt(max(-2.0 * np.log(max(R, 1e-12)),
                                  1e-4)) / (2 * np.pi)
            neff = w.sum() ** 2 / (w ** 2).sum()
            bw = 1.06 * sigma_c * neff ** (-0.2) / 3.0
        self.bw = float(max(bw, 2.0 / ngrid))
        # bin CENTERS: anchoring at left edges would rotate the whole
        # density by -0.5/ngrid (a systematic phase bias)
        grid = (np.arange(ngrid) + 0.5) / ngrid
        # O(N + ngrid log ngrid): histogram the weighted phases onto
        # the grid and circular-convolve with the wrapped-Gaussian
        # kernel by FFT
        hist, _ = np.histogram(ph, bins=ngrid, range=(0.0, 1.0),
                               weights=w)
        off = np.arange(ngrid) / ngrid
        dcirc = np.minimum(off, 1.0 - off)
        kern = np.exp(-0.5 * (dcirc / self.bw) ** 2)
        dens = np.real(np.fft.ifft(np.fft.fft(hist)
                                   * np.fft.fft(kern)))
        self._grid = grid
        self._dens = np.maximum(dens, 0.0) / np.mean(
            np.maximum(dens, 0.0))

    def __call__(self, phases) -> np.ndarray:
        ph = np.mod(np.asarray(phases, np.float64), 1.0)
        # circular interpolation: pad both ends with the wrapped
        # neighbors (grid runs 0.5/G .. 1-0.5/G)
        xp = np.concatenate([[self._grid[-1] - 1.0], self._grid,
                             [self._grid[0] + 1.0]])
        fp = np.concatenate([[self._dens[-1]], self._dens,
                             [self._dens[0]]])
        return np.interp(ph, xp, fp)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


class LCTemplate:
    """Weighted sum of primitives + uniform background (reference:
    lctemplate.LCTemplate). Holds primitive *types*; all numeric state
    lives in the flat theta vector so the pdf is a pure function.
    ``device`` (None means "cuda") is where ``__call__`` evaluates."""

    def __init__(self, primitives: Sequence[LCPrimitive],
                 norms: Sequence[float], locs: Sequence[float],
                 widths, device=None):
        self.device = resolve_device(device)
        self.primitives = list(primitives)
        m = len(self.primitives)
        shapes = [np.atleast_1d(np.asarray(w, dtype=np.float64))
                  for w in widths]
        for p, s in zip(self.primitives, shapes):
            if s.shape != (p.n_shape,):
                raise ValueError(
                    f"{p.name} needs {p.n_shape} shape params, "
                    f"got {s.shape}")
        if not len(norms) == len(locs) == m:
            raise ValueError(f"{m} primitives need {m} norms and locs")
        self._shape_sizes = [p.n_shape for p in self.primitives]
        self.theta = self.pack(np.asarray(norms, dtype=np.float64),
                               np.asarray(locs, dtype=np.float64),
                               shapes)

    # ---- flat parameter vector ------------------------------------

    @staticmethod
    def pack(norms, locs, shapes: List[np.ndarray]) -> np.ndarray:
        bg = 1.0 - np.sum(norms)
        if bg <= 0:
            raise ValueError("norms must sum to < 1")
        logits = np.log(np.concatenate([[bg], norms]))
        return np.concatenate([logits, locs,
                               np.log(np.concatenate(shapes))])

    def unpack(self, theta):
        """(norms, locs, [shapes]) as float64 tensors, on the device of
        ``theta`` when it is a tensor, else on the host (the CPU)."""
        t = theta if torch.is_tensor(theta) else _f64(theta, "cpu")
        m = len(self.primitives)
        p = torch.softmax(t[:m + 1], dim=0)
        locs = torch.remainder(t[m + 1:2 * m + 1], 1.0)
        flat = torch.exp(t[2 * m + 1:])
        shapes, off = [], 0
        for n in self._shape_sizes:
            shapes.append(flat[off:off + n])
            off += n
        return p[1:], locs, shapes

    # ---- evaluation ------------------------------------------------

    def _pdf_fn(self):
        """pdf(theta, phi): the template density at phases ``phi`` for
        the flat parameter tensor ``theta``, on their device."""
        prim_pdfs = [p.pdf for p in self.primitives]
        sizes = list(self._shape_sizes)
        m = len(prim_pdfs)

        def pdf(theta, phi):
            p = torch.softmax(theta[:m + 1], dim=0)
            locs = theta[m + 1:2 * m + 1]
            flat = torch.exp(theta[2 * m + 1:])
            val = p[0] * torch.ones_like(phi)
            off = 0
            for k, f in enumerate(prim_pdfs):
                val = val + p[k + 1] * f(phi, locs[k],
                                         flat[off:off + sizes[k]])
                off += sizes[k]
            return val

        return pdf

    def __call__(self, phases, theta=None) -> np.ndarray:
        theta = self.theta if theta is None else theta
        return self._pdf_fn()(_f64(theta, self.device),
                              _f64(phases, self.device)).cpu().numpy()

    @property
    def norms(self) -> np.ndarray:
        return self.unpack(self.theta)[0].numpy()

    @property
    def locs(self) -> np.ndarray:
        return self.unpack(self.theta)[1].numpy()

    @property
    def widths(self) -> List[np.ndarray]:
        return [s.numpy() for s in self.unpack(self.theta)[2]]

    # ---- profile statistics (reference: LCTemplate delta/Delta) ----

    def fwhms(self) -> List[float]:
        return [p.fwhm(s) for p, s in
                zip(self.primitives, self.widths)]

    def delta(self) -> Optional[float]:
        """Phase of the highest-amplitude peak (reference:
        LCTemplate.delta: radio-to-peak offset)."""
        if not self.primitives:
            return None
        k = int(np.argmax(self.norms))
        return float(self.locs[k])

    def Delta(self) -> Optional[float]:
        """Separation of the two strongest peaks in phase (reference:
        LCTemplate.Delta)."""
        if len(self.primitives) < 2:
            return None
        order = np.argsort(self.norms)[::-1]
        a, b = self.locs[order[0]], self.locs[order[1]]
        d = abs(a - b)
        return float(min(d, 1.0 - d))

    def param_mask(self, free_norms=True, free_locs=True,
                   free_widths=True, prims=None) -> np.ndarray:
        """Boolean mask over theta selecting FREE entries, for
        LCFitter's free= argument (reference: the LCNorm/LCPrimitive
        free arrays). ``prims`` restricts to a subset of primitive
        indices; norms live on a softmax simplex, so freeing any norm
        also frees the background logit (holding the rest fixed keeps
        their RATIOS fixed, the natural analog of the reference's fixed
        norms)."""
        m = len(self.primitives)
        sel = list(range(m)) if prims is None else list(prims)
        mask = np.zeros(len(np.asarray(self.theta)), bool)
        if free_norms:
            mask[0] = True
            for k in sel:
                mask[1 + k] = True
        if free_locs:
            for k in sel:
                mask[m + 1 + k] = True
        if free_widths:
            off = 2 * m + 1
            for k, nsh in enumerate(self._shape_sizes):
                if k in sel:
                    mask[off:off + nsh] = True
                off += nsh
        return mask

    def rotate(self, dphi: float):
        """Shift every peak location by dphi (mod 1), in place
        (reference: LCTemplate.rotate)."""
        m = len(self.primitives)
        th = np.asarray(self.theta).copy()
        th[m + 1:2 * m + 1] = np.mod(th[m + 1:2 * m + 1] + dphi, 1.0)
        self.theta = th

    def integrate(self, ph1: float, ph2: float, n: int = 2001) -> float:
        """Trapezoid integral of the pdf on [ph1, ph2] (reference:
        LCTemplate.integrate); used for binned likelihoods."""
        xs = np.linspace(ph1, ph2, n)
        return float(np.trapezoid(self(xs), xs))

    def random(self, n: int,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Draw n photon phases from the template (for simulation
        tests; reference: LCTemplate.random): numpy draws from the
        host's norms, locs and widths, the same on every device."""
        rng = rng or np.random.default_rng()
        norms = self.norms
        locs = self.locs
        shapes = self.widths
        bg = 1.0 - norms.sum()
        comp = rng.choice(len(norms) + 1, size=n,
                          p=np.concatenate([[bg], norms]))
        out = rng.uniform(size=n)  # background
        for k, prim in enumerate(self.primitives):
            idx = comp == k + 1
            nk = int(idx.sum())
            if nk == 0:
                continue
            s = shapes[k]
            if isinstance(prim, LCSkewGaussian):
                # skew-normal draw: z = d*|z0| + sqrt(1-d^2)*z1 with
                # d = alpha/sqrt(1+alpha^2) (Azzalini representation)
                alpha = np.log(s[1])
                dlt = alpha / np.sqrt(1 + alpha * alpha)
                z0 = np.abs(rng.normal(size=nk))
                z1 = rng.normal(size=nk)
                draw = locs[k] + s[0] * (dlt * z0
                                         + np.sqrt(1 - dlt ** 2) * z1)
            elif isinstance(prim, LCGaussian):
                draw = rng.normal(locs[k], s[0], size=nk)
            elif isinstance(prim, LCGaussian2):
                side = rng.uniform(size=nk) < s[0] / (s[0] + s[1])
                mag = np.abs(rng.normal(0.0, 1.0, size=nk))
                draw = locs[k] + np.where(side, -mag * s[0], mag * s[1])
            elif isinstance(prim, LCVonMises):
                kappa = 1.0 / (2 * np.pi * s[0]) ** 2
                draw = locs[k] + rng.vonmises(0.0, kappa, size=nk) / (
                    2 * np.pi)
            elif isinstance(prim, LCTopHat):
                draw = locs[k] + s[0] * (rng.uniform(size=nk) - 0.5)
            elif isinstance(prim, LCLorentzian2):
                side = rng.uniform(size=nk) < s[0] / (s[0] + s[1])
                mag = np.abs(np.tan(np.pi * (rng.uniform(size=nk)
                                             - 0.5)))
                draw = locs[k] + np.where(side, -mag * s[0],
                                          mag * s[1])
            else:  # Lorentzian: Cauchy with HWHM already in phase
                draw = locs[k] + s[0] * np.tan(
                    np.pi * (rng.uniform(size=nk) - 0.5))
            out[idx] = draw
        return np.mod(out, 1.0)

    def __str__(self):
        lines = []
        for p, nrm, loc, sh in zip(self.primitives, self.norms,
                                   self.locs, self.widths):
            ss = " ".join(f"{x:.6g}" for x in sh)
            lines.append(f"{p.name:<12} norm={nrm:.4f} loc={loc:.4f} "
                         f"shape=[{ss}]")
        lines.append(f"background   {1.0 - self.norms.sum():.4f}")
        return "\n".join(lines)


def make_template(spec: Sequence[Tuple[str, float, float, object]],
                  device=None) -> LCTemplate:
    """Build from (name, norm, loc, width-or-widths) rows; names are
    the primitive ``name`` attributes ('gaussian', 'vonmises', ...).
    ``device`` (None means "cuda") is the template's."""
    prims, norms, locs, widths = [], [], [], []
    for name, nrm, loc, w in spec:
        try:
            prims.append(_PRIM_TYPES[name]())
        except KeyError:
            raise ValueError(f"unknown primitive {name!r}; know "
                             f"{sorted(_PRIM_TYPES)}") from None
        norms.append(nrm)
        locs.append(loc)
        widths.append(w)
    return LCTemplate(prims, norms, locs, widths, device=device)


# ---- template file I/O (reference: lcprimitives prim_io /
# lctemplate.prim_io read/write of .gauss profile files) -------------

def write_template(template: LCTemplate, path: str):
    """Plain-text profile file: one primitive per line,
    ``name norm loc shape...``, '#' comments (the reference's format:
    the header's first line names the reference package, so files of
    either package are byte-identical)."""
    with open(path, "w") as fh:
        fh.write("# pint_tpu pulse-profile template\n")
        fh.write("# name norm loc shape_params...\n")
        for p, nrm, loc, sh in zip(template.primitives, template.norms,
                                   template.locs, template.widths):
            ss = " ".join(repr(float(x)) for x in sh)
            fh.write(f"{p.name} {float(nrm)!r} {float(loc)!r} {ss}\n")


def read_template(path: str, device=None) -> LCTemplate:
    """Read a template file of either package; ``device`` (None means
    "cuda") is the template's."""
    spec = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            toks = line.split()
            name = toks[0].lower()
            vals = [float(t) for t in toks[1:]]
            if len(vals) < 3:
                raise ValueError(f"bad template line: {line!r}")
            spec.append((name, vals[0], vals[1],
                         vals[2] if len(vals) == 3 else vals[2:]))
    if not spec:
        raise ValueError(f"no primitives found in {path}")
    return make_template(spec, device=device)


class GaussianPrior:
    """Gaussian penalty on selected theta entries (reference:
    lcfitters' location/width priors keeping peaks from wandering).
    ``nll`` runs on the device of the theta it is given."""

    def __init__(self, indices, means, sigmas):
        self.indices = np.asarray(indices, dtype=np.int64)
        self.means = np.asarray(means, dtype=np.float64)
        self.sigmas = np.asarray(sigmas, dtype=np.float64)

    def nll(self, theta):
        dev = theta.device
        idx = torch.as_tensor(self.indices, device=dev)
        z = (theta[idx] - _f64(self.means, dev)) / _f64(self.sigmas, dev)
        return 0.5 * torch.sum(z * z)


def _minimize(fn, x0, maxiter: int):
    """scipy BFGS with the reference's options: dense BFGS (theta is
    tiny, 3m+1, and scipy's L-BFGS-B line search stalls on the
    phase-periodic landscape)."""
    from scipy.optimize import minimize

    return minimize(fn, x0, jac=True, method="BFGS",
                    options={"maxiter": maxiter, "gtol": 1e-6})


def _converged(res) -> Tuple[bool, float]:
    """(success, |grad|): BFGS often ends with "precision loss" right at
    the optimum; a small gradient relative to |objective| is
    convergence (the reference's rule)."""
    gnorm = float(np.linalg.norm(res.jac))
    ok = bool(res.success) or gnorm < 1e-4 * max(1.0, abs(float(res.fun)))
    return ok, gnorm


def _value_and_grad(vg, theta: torch.Tensor) -> Tuple[float, np.ndarray]:
    """One device evaluation of ``vg`` (a ``torch.func.grad_and_value``)
    and one read-back of [value, grad]."""
    g, v = vg(theta)
    out = torch.cat([v.reshape(1), g]).cpu().numpy()
    return float(out[0]), out[1:]


class LCFitter:
    """Unbinned weighted ML template fitter (reference:
    lcfitters.LCFitter). loglikelihood = sum_i log(w_i f(phi_i) +
    (1-w_i)): the photon-axis reduction runs on ``device`` (None means
    "cuda") and the optimizer is host BFGS over its value and gradient,
    one device evaluation and one read-back a call."""

    def __init__(self, template: LCTemplate, phases,
                 weights=None, prior: Optional[GaussianPrior] = None,
                 device=None):
        self.template = template
        self.device = dev = resolve_device(device)
        self.phases = torch.remainder(
            torch.as_tensor(phases, dtype=torch.float64, device=dev), 1.0)
        self.weights = (torch.ones_like(self.phases) if weights is None
                        else torch.as_tensor(weights, dtype=torch.float64,
                                             device=dev))
        pdf = template._pdf_fn()
        ph, w = self.phases, self.weights
        wc = 1.0 - w

        def nll(theta):
            f = pdf(theta, ph)
            val = -torch.sum(torch.log(w * f + wc))
            if prior is not None:
                val = val + prior.nll(theta)
            return val

        self._nll = nll
        self._valgrad = torch.func.grad_and_value(nll)
        self._hess = torch.func.hessian(nll)

    def loglikelihood(self, theta=None) -> float:
        theta = self.template.theta if theta is None else theta
        return -float(self._nll(_f64(theta, self.device)))

    def fit(self, maxiter: int = 500, compute_errors: bool = True,
            free=None) -> dict:
        """ML fit; updates the template's theta in place. With
        compute_errors, invert the exact autodiff Hessian at the
        optimum for the theta covariance (reference: LCFitter's
        hess_errors). ``free`` is a boolean theta mask (see
        LCTemplate.param_mask) — fixed entries are held at their
        current values."""
        theta0 = np.asarray(self.template.theta, np.float64)
        free = np.ones(len(theta0), bool) if free is None \
            else np.asarray(free, bool)

        def f(x):
            full = theta0.copy()
            full[free] = x
            v, g = _value_and_grad(self._valgrad, _f64(full, self.device))
            return v, g[free]

        res = _minimize(f, theta0[free], maxiter)
        theta = theta0.copy()
        theta[free] = np.asarray(res.x)
        self.template.theta = theta
        ok, gnorm = _converged(res)
        out = {"loglikelihood": -float(res.fun),
               "iterations": int(res.nit),
               "grad_norm": gnorm,
               "success": ok}
        if compute_errors:
            H = self._hess(_f64(theta, self.device)).cpu().numpy()
            Hf = H[np.ix_(free, free)]
            err = np.zeros(len(theta))
            try:
                cov = np.linalg.inv(Hf)
                err[free] = np.sqrt(np.maximum(np.diag(cov), 0.0))
            except np.linalg.LinAlgError:
                cov = None
                err[free] = np.nan
            out["theta_cov"] = cov  # free-subset covariance
            out["theta_err"] = err  # full-length, 0 at fixed entries
        return out

    # ---- binned fit (reference: LCFitter chi-squared path) ---------

    def fit_binned(self, nbins: int = 64, maxiter: int = 500) -> dict:
        """Weighted binned Poisson-chi2 fit: faster for huge photon
        sets; bins the weighted phase histogram once on the host, then
        minimizes chi2 against bin-center pdf values on the device."""
        w = self.weights.cpu().numpy()
        ph = self.phases.cpu().numpy()
        hist, edges = np.histogram(ph, bins=nbins, range=(0.0, 1.0),
                                   weights=w)
        var, _ = np.histogram(ph, bins=nbins, range=(0.0, 1.0),
                              weights=w * w)
        centers = 0.5 * (edges[:-1] + edges[1:])
        scale = float(w.sum() / nbins)
        pdf = self.template._pdf_fn()
        dev = self.device
        cj, hj = _f64(centers, dev), _f64(hist, dev)
        vj = _f64(np.maximum(var, 1e-12), dev)

        def chi2(theta):
            mu = pdf(theta, cj) * scale
            return torch.sum((hj - mu) ** 2 / vj)

        vg = torch.func.grad_and_value(chi2)
        res = _minimize(lambda x: _value_and_grad(vg, _f64(x, dev)),
                        np.asarray(self.template.theta), maxiter)
        self.template.theta = np.asarray(res.x)
        ok, _ = _converged(res)
        return {"chi2": float(res.fun), "nbins": nbins,
                "iterations": int(res.nit), "success": ok}

    def __str__(self):
        return (f"LCFitter: {self.phases.shape[0]} photons, "
                f"logL={self.loglikelihood():.2f}\n"
                f"{self.template}")
