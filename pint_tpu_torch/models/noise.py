"""Noise models: white-noise scaling and correlated-noise bases (a port
of pint_tpu/models/noise.py; reference: src/pint/models/noise_model.py
NoiseComponent, ScaleToaError, ScaleDmError, EcorrNoise, PLRedNoise,
PLDMNoise, create_quantization_matrix, create_fourier_design_matrix,
powerlaw).

Host numpy, copied: every noise component reduces to static arrays — a
scaled per-TOA sigma vector, a dense (N, q) basis matrix and a (q,)
prior-variance vector, or ECORR's (eid, jvar) epoch segments — which the
fitters move to the device once. Noise hyperparameters are not
least-squares-fittable, as in the reference.

Conventions:
  sigma_scaled^2 = EFAC^2 * (sigma^2 + EQUAD^2)      [TEMPO2/PINT]
  TNEQ is log10(EQUAD/s); EQUAD/ECORR par values are in microseconds.
  ECORR: TOAs quantized into observing epochs (bucket gap 0.5 day,
  buckets with >= 2 TOAs), weight ECORR^2 per epoch.
  Red noise: Fourier pairs sin/cos(2 pi j t / T_span), j = 1..k; weight
  per pair P(f_j) * Delta_f with
  P(f) = A^2/(12 pi^2) f_yr^(gamma-3) f^(-gamma)  [s^2].

Wideband DM channel: ScaleDmError scales the DM uncertainties
(DMEQUAD added first, then DMEFAC multiplies), and PLDMNoise's basis
couples into the DM rows through ``noise_dm_basis``, as does
PLSWNoise's (the solar wind is a DM perturbation too). PLChromNoise
scales the basis by (1400 MHz/nu)^alpha with ChromaticCM's TNCHROMIDX.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.parameter import (
    floatParameter,
    intParameter,
    maskParameter,
)
from pint_tpu_torch.models.timing_model import Component

__all__ = [
    "NoiseComponent", "ScaleToaError", "ScaleDmError", "EcorrNoise",
    "PLRedNoise", "PLDMNoise", "PLChromNoise", "PLSWNoise",
    "create_quantization_matrix", "quantization_buckets",
    "create_fourier_design_matrix", "powerlaw", "EcorrOverlapError",
]

FYR = 1.0 / (86400.0 * 365.25)  # 1/yr in Hz


class EcorrOverlapError(ValueError):
    """A TOA fell into two ECORR epochs (overlapping masks)."""


def _tdb_seconds(toas, ref_day=None) -> np.ndarray:
    """TDB seconds since the first TOA's day (f64 is ample for a noise
    basis: sub-ns phase error on multi-decade spans). ``ref_day``
    pins the zero point to another dataset's first day (a time shift
    rotates each Fourier sin/cos pair)."""
    if toas.tdb_day is None:
        raise ValueError("TOAs need compute_TDBs() before noise bases")
    day0 = toas.tdb_day.min() if ref_day is None else ref_day
    return ((toas.tdb_day - day0) + toas.tdb_frac[0]
            + toas.tdb_frac[1]) * 86400.0


def powerlaw(f: np.ndarray, A: float, gamma: float) -> np.ndarray:
    """Power-law PSD [s^2/Hz-ish per-bin convention of the reference]:
    P(f) = A^2/(12 pi^2) * f_yr^(gamma-3) * f^(-gamma)
    (reference: noise_model.powerlaw)."""
    return A ** 2 / (12.0 * np.pi ** 2) * FYR ** (gamma - 3.0) \
        * np.asarray(f, dtype=np.float64) ** (-gamma)


def quantization_buckets(t_days: np.ndarray, dt_days: float = 0.5,
                         nmin: int = 2) -> List[np.ndarray]:
    """Index lists of observing epochs: a new bucket starts whenever
    the gap to the previous (sorted) time exceeds dt_days; buckets with
    < nmin members are dropped. The sparse primitive behind both the
    dense quantization matrix and the O(N) Sherman-Morrison segment
    path."""
    t = np.asarray(t_days, dtype=np.float64)
    isort = np.argsort(t)
    buckets: List[List[int]] = []
    last = None
    for i in isort:
        if last is None or t[i] - last > dt_days:
            buckets.append([])
        buckets[-1].append(i)
        last = t[i]
    return [np.asarray(b) for b in buckets if len(b) >= nmin]


def create_quantization_matrix(t_days: np.ndarray, dt_days: float = 0.5,
                               nmin: int = 2) -> np.ndarray:
    """Group times into observing epochs; return the (N, N_epoch) 0/1
    membership matrix, keeping only epochs with >= nmin TOAs
    (reference: noise_model.create_quantization_matrix).
    """
    keep = quantization_buckets(t_days, dt_days, nmin)
    U = np.zeros((len(np.asarray(t_days)), len(keep)), dtype=np.float64)
    for j, b in enumerate(keep):
        U[b, j] = 1.0
    return U


def create_fourier_design_matrix(t_sec: np.ndarray, nmodes: int,
                                 Tspan: Optional[float] = None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(F, freqs): F is (N, 2*nmodes) with columns
    [sin(2pi f_1 t), cos(2pi f_1 t), sin(2pi f_2 t), ...] and freqs the
    per-column frequencies [Hz]
    (reference: noise_model.create_fourier_design_matrix)."""
    t = np.asarray(t_sec, dtype=np.float64)
    T = Tspan if Tspan is not None else (t.max() - t.min())
    f = np.arange(1, nmodes + 1, dtype=np.float64) / T
    F = np.zeros((len(t), 2 * nmodes))
    arg = 2.0 * np.pi * t[:, None] * f[None, :]
    F[:, ::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F, np.repeat(f, 2)




def _spec(d):
    """{name-or-'PREFIX*': parse_unit(text)} from a plain dict (see
    pint_tpu_torch.units._spec_lookup for the key rules)."""
    from pint_tpu_torch.units import parse_unit

    return {k: parse_unit(v) for k, v in d.items()}


class NoiseComponent(Component):
    """Base: category 'noise'; contributes no delay/phase. Subclasses
    override one of the noise hooks."""

    category = "noise"
    register = False
    is_basis_noise = False  # True => contributes (basis, weights) to GLS

    def scale_toa_sigma_s2(self, toas, sigma2_s2: np.ndarray) -> np.ndarray:
        """Transform per-TOA variance [s^2] (white components only)."""
        return sigma2_s2

    def scale_dm_sigma2(self, toas, sigma2: np.ndarray) -> np.ndarray:
        """Transform per-TOA wideband-DM variance [(pc/cm^3)^2]."""
        return sigma2

    def noise_basis_weight(self, toas, tspan=None,
                           tref_day=None):
        """(F (N,q), phi (q,)) for basis components, else None.

        ``tspan`` [s] pins the Fourier fundamental 1/T instead of
        deriving it from the passed TOAs' own span, so rows of another
        TOA set can be evaluated on the same frequencies. Ignored by
        non-Fourier bases (ECORR quantization)."""
        return None


class ScaleToaError(NoiseComponent):
    """EFAC/EQUAD/TNEQ white-noise rescaling
    (reference: ScaleToaError.scale_toa_sigma)."""

    register = True


    def param_dimensions(self):
        return _spec({"EFAC*": "", "EQUAD*": "us",
                      "TNEQ*": "log10(s)"})

    def __init__(self):
        super().__init__()
        self.efacs: list = []
        self.equads: list = []
        self.tneqs: list = []

    def setup(self):
        self.efacs = sorted((n for n in self.params
                             if n.startswith("EFAC")),
                            key=lambda n: self.params[n].index)
        self.equads = sorted((n for n in self.params
                              if n.startswith("EQUAD")),
                             key=lambda n: self.params[n].index)
        self.tneqs = sorted((n for n in self.params
                             if n.startswith("TNEQ")),
                            key=lambda n: self.params[n].index)

    def add_noise_param(self, prefix, key, key_value, value, index=None):
        idx = index or (len([n for n in self.params
                             if n.startswith(prefix)]) + 1)
        p = maskParameter(prefix, index=idx, key=key,
                          key_value=key_value, value=value,
                          units={"EFAC": "", "EQUAD": "us",
                                 "TNEQ": "log10(s)"}[prefix])
        self.add_param(p)
        self.setup()
        return p

    def scale_toa_sigma_s2(self, toas, sigma2_s2):
        """sigma^2 -> EFAC^2 (sigma^2 + EQUAD^2), per mask group."""
        out = np.array(sigma2_s2, dtype=np.float64)
        for name in self.equads:
            p = self.params[name]
            if p.value is None:
                continue
            m = p.select_mask(toas)
            out[m] = out[m] + (p.value * 1e-6) ** 2
        for name in self.tneqs:
            p = self.params[name]
            if p.value is None:
                continue
            m = p.select_mask(toas)
            out[m] = out[m] + (10.0 ** p.value) ** 2
        for name in self.efacs:
            p = self.params[name]
            if p.value is None:
                continue
            m = p.select_mask(toas)
            out[m] = out[m] * p.value ** 2
        return out


class ScaleDmError(NoiseComponent):
    """DMEFAC/DMEQUAD scaling of wideband DM-channel uncertainties
    (reference: ScaleDmError.scale_dm_sigma)."""

    register = True

    def param_dimensions(self):
        return _spec({"DMEFAC*": "", "DMEQUAD*": "pc cm^-3"})

    def __init__(self):
        super().__init__()
        self.dmefacs: list = []
        self.dmequads: list = []

    def setup(self):
        self.dmefacs = sorted((n for n in self.params
                               if n.startswith("DMEFAC")),
                              key=lambda n: self.params[n].index)
        self.dmequads = sorted((n for n in self.params
                                if n.startswith("DMEQUAD")),
                               key=lambda n: self.params[n].index)

    def scale_dm_sigma2(self, toas, sigma2):
        """sigma^2 -> DMEFAC^2 (sigma^2 + DMEQUAD^2), per mask group."""
        out = np.array(sigma2, dtype=np.float64)
        for name in self.dmequads:
            p = self.params[name]
            if p.value is None:
                continue
            m = p.select_mask(toas)
            out[m] = out[m] + p.value ** 2
        for name in self.dmefacs:
            p = self.params[name]
            if p.value is None:
                continue
            m = p.select_mask(toas)
            out[m] = out[m] * p.value ** 2
        return out


class EcorrNoise(NoiseComponent):
    """Epoch-correlated jitter noise (ECORR): fully correlated within an
    observing epoch, white across epochs; enters GLS as a 0/1
    quantization basis with weight ECORR^2 per epoch
    (reference: EcorrNoise.ecorr_basis_weight_pair)."""

    register = True


    def param_dimensions(self):
        return _spec({"ECORR*": "us"})

    is_basis_noise = True

    def __init__(self):
        super().__init__()
        self.ecorrs: list = []

    def setup(self):
        self.ecorrs = sorted((n for n in self.params
                              if n.startswith("ECORR")),
                             key=lambda n: self.params[n].index)

    def add_ecorr(self, key, key_value, value, index=None):
        idx = index or (len(self.ecorrs) + 1)
        p = maskParameter("ECORR", index=idx, key=key,
                          key_value=key_value, value=value, units="us")
        self.add_param(p)
        self.setup()
        return p

    def noise_basis_weight(self, toas, tspan=None,
                           tref_day=None):
        mjd = toas.get_mjds()
        Us, ws = [], []
        for name in self.ecorrs:
            p = self.params[name]
            if p.value is None:
                continue
            mask = p.select_mask(toas)
            idx = np.flatnonzero(mask)
            if len(idx) == 0:
                continue
            Usub = create_quantization_matrix(mjd[idx])
            if Usub.shape[1] == 0:
                continue
            U = np.zeros((toas.ntoas, Usub.shape[1]))
            U[idx, :] = Usub
            Us.append(U)
            ws.append(np.full(Usub.shape[1], (p.value * 1e-6) ** 2))
        if not Us:
            return None
        return np.concatenate(Us, axis=1), np.concatenate(ws)

    def noise_epoch_segments(self, toas):
        """Sparse epoch structure without densifying the quantization
        matrix: (eid (N,) int32 — epoch index or -1 for 'no epoch' —,
        jvar (K,) per-epoch variances [s^2]), or None when inactive.
        Column order matches noise_basis_weight exactly (same mask and
        bucket enumeration), O(N) memory at any scale. Raises
        EcorrOverlapError when ECORR masks overlap (a TOA in two epochs
        has no rank-1-per-epoch representation; callers fall back to
        the dense basis)."""
        mjd = toas.get_mjds()
        eid = np.full(toas.ntoas, -1, dtype=np.int32)
        jvar: list = []
        for name in self.ecorrs:
            p = self.params[name]
            if p.value is None:
                continue
            idx = np.flatnonzero(p.select_mask(toas))
            if len(idx) == 0:
                continue
            for b in quantization_buckets(mjd[idx]):
                rows = idx[b]
                if np.any(eid[rows] >= 0):
                    raise EcorrOverlapError(
                        f"overlapping ECORR masks ({name})")
                eid[rows] = len(jvar)
                jvar.append((p.value * 1e-6) ** 2)
        if not jvar:
            return None
        return eid, np.asarray(jvar)


class PLRedNoise(NoiseComponent):
    """Power-law achromatic red noise as a Fourier-basis GP
    (reference: PLRedNoise.pl_rn_basis_weight_pair).

    Amplitude conventions: TNREDAMP is log10(A) (TempoNest); RNAMP is
    the TEMPO-style amplitude related by
    A = RNAMP * 2 pi sqrt(3) / (86400 * 365.25 * 1e6), gamma = -RNIDX.
    """

    register = True


    def param_dimensions(self):
        return _spec({"TNREDAMP": "", "TNREDGAM": "",
                      "RNAMP": "us/sqrt(yr)", "RNIDX": ""})

    is_basis_noise = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter(
            "TNREDAMP", units="log10(strain)", aliases=["TNRedAmp"],
            description="log10 red-noise amplitude"))
        self.add_param(floatParameter(
            "TNREDGAM", units="", aliases=["TNRedGam"],
            description="red-noise spectral index gamma"))
        self.add_param(intParameter(
            "TNREDC", value=30, aliases=["TNRedC", "TNREDFLOW"],
            description="number of Fourier modes"))
        self.add_param(floatParameter("RNAMP", units="us/sqrt(yr)"))
        self.add_param(floatParameter("RNIDX", units=""))

    def amplitude_gamma(self):
        if self.TNREDAMP.value is not None:
            return 10.0 ** self.TNREDAMP.value, self.TNREDGAM.value
        if self.RNAMP.value is not None:
            fac = (86400.0 * 365.25 * 1e6) / (2.0 * np.pi * np.sqrt(3.0))
            return self.RNAMP.value / fac, -self.RNIDX.value
        return None, None

    def validate(self):
        A, g = self.amplitude_gamma()
        if A is not None and g is None:
            raise ValueError("red-noise amplitude set without index "
                             "(TNREDGAM/RNIDX)")

    def noise_basis_weight(self, toas, tspan=None,
                           tref_day=None):
        A, gamma = self.amplitude_gamma()
        if A is None:
            return None
        nmodes = int(self.TNREDC.value or 30)
        t = _tdb_seconds(toas, ref_day=tref_day)
        F, freqs = create_fourier_design_matrix(t, nmodes, Tspan=tspan)
        df = freqs[0]
        phi = powerlaw(freqs, A, gamma) * df
        return F, phi


def _dm_rows_from_time_basis(toas, F_time):
    """Wideband DM-channel block [pc/cm^3 per coefficient] of a pure
    nu^-2 (DM-perturbation) noise process, from its time-channel block:
    delay rows are DMconst * DM / nu^2, so DM rows = F_time * nu^2 /
    DMconst, on the same modes and time grid. Rows at infinite frequency
    (barycentred TOAs) carry F_time = 0 and would be 0 * inf: they are
    set to 0, so the process does not inform the DM channel there."""
    nu = np.asarray(toas.get_freqs())
    fin = np.isfinite(nu)
    scale = np.zeros_like(nu)
    scale[fin] = nu[fin] * nu[fin] / DMconst
    return np.asarray(F_time) * scale[:, None]


class PLDMNoise(NoiseComponent):
    """Power-law DM (chromatic nu^-2) noise: the red-noise Fourier basis
    with each row scaled by (1400 MHz / nu)^2
    (reference: PLDMNoise.pl_dm_basis_weight_pair)."""

    register = True

    def param_dimensions(self):
        return _spec({"TNDMAMP": "", "TNDMGAM": ""})

    is_basis_noise = True

    REF_FREQ_MHZ = 1400.0

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter(
            "TNDMAMP", units="log10", aliases=["TNDMAmp"],
            description="log10 DM-noise amplitude"))
        self.add_param(floatParameter(
            "TNDMGAM", units="", aliases=["TNDMGam"],
            description="DM-noise spectral index"))
        self.add_param(intParameter(
            "TNDMC", value=30, aliases=["TNDMC"],
            description="number of DM Fourier modes"))

    def noise_basis_weight(self, toas, tspan=None,
                           tref_day=None):
        if self.TNDMAMP.value is None:
            return None
        A = 10.0 ** self.TNDMAMP.value
        gamma = self.TNDMGAM.value
        nmodes = int(self.TNDMC.value or 30)
        t = _tdb_seconds(toas, ref_day=tref_day)
        F, freqs = create_fourier_design_matrix(t, nmodes, Tspan=tspan)
        scale = (self.REF_FREQ_MHZ / toas.get_freqs()) ** 2
        F = F * scale[:, None]
        df = freqs[0]
        phi = powerlaw(freqs, A, gamma) * df
        return F, phi

    def noise_dm_basis(self, toas, F_time):
        """Wideband DM-channel block (see _dm_rows_from_time_basis)."""
        return _dm_rows_from_time_basis(toas, F_time)


class PLChromNoise(NoiseComponent):
    """Power-law chromatic noise with a general index: the red-noise
    Fourier basis scaled per row by (1400 MHz/nu)^alpha, alpha =
    TNCHROMIDX of the ChromaticCM component (4 without one) (reference:
    PLChromNoise.pl_chrom_basis_weight_pair)."""

    register = True

    def param_dimensions(self):
        return _spec({"TNCHROMAMP": "", "TNCHROMGAM": ""})

    is_basis_noise = True

    REF_FREQ_MHZ = 1400.0

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter(
            "TNCHROMAMP", units="log10", aliases=["TNChromAmp"],
            description="log10 chromatic-noise amplitude"))
        self.add_param(floatParameter(
            "TNCHROMGAM", units="", aliases=["TNChromGam"],
            description="chromatic-noise spectral index"))
        self.add_param(intParameter(
            "TNCHROMC", value=30, aliases=["TNChromC"],
            description="number of chromatic Fourier modes"))

    def _alpha(self) -> float:
        from pint_tpu_torch.models.components_tail import chromatic_index

        return chromatic_index(getattr(self, "_parent", None))

    def validate(self):
        if self.TNCHROMAMP.value is not None and \
                self.TNCHROMGAM.value is None:
            raise ValueError("TNCHROMAMP set without TNCHROMGAM")

    def noise_basis_weight(self, toas, tspan=None,
                           tref_day=None):
        if self.TNCHROMAMP.value is None:
            return None
        A = 10.0 ** self.TNCHROMAMP.value
        gamma = self.TNCHROMGAM.value
        nmodes = int(self.TNCHROMC.value or 30)
        t = _tdb_seconds(toas, ref_day=tref_day)
        F, freqs = create_fourier_design_matrix(t, nmodes, Tspan=tspan)
        scale = (self.REF_FREQ_MHZ / toas.get_freqs()) ** self._alpha()
        F = F * np.where(np.isfinite(scale), scale, 0.0)[:, None]
        df = freqs[0]
        phi = powerlaw(freqs, A, gamma) * df
        return F, phi


class PLSWNoise(NoiseComponent):
    """Power-law solar-wind noise: the Fourier basis scaled per row by
    the solar wind's line-of-sight geometry (at the catalogue position)
    times (1400 MHz/nu)^2 (reference: PLSWNoise.pl_sw_basis_weight_pair).
    """

    register = True

    def param_dimensions(self):
        return _spec({"TNSWAMP": "", "TNSWGAM": ""})

    is_basis_noise = True

    REF_FREQ_MHZ = 1400.0

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter(
            "TNSWAMP", units="log10", aliases=["TNSWAmp"],
            description="log10 solar-wind-noise amplitude"))
        self.add_param(floatParameter(
            "TNSWGAM", units="", aliases=["TNSWGam"],
            description="solar-wind-noise spectral index"))
        self.add_param(intParameter(
            "TNSWC", value=10, aliases=["TNSWC"],
            description="number of solar-wind Fourier modes"))

    def validate(self):
        if self.TNSWAMP.value is not None and \
                self.TNSWGAM.value is None:
            raise ValueError("TNSWAMP set without TNSWGAM")

    def noise_basis_weight(self, toas, tspan=None,
                           tref_day=None):
        if self.TNSWAMP.value is None:
            return None
        parent = getattr(self, "_parent", None)
        if parent is None:
            return None
        from pint_tpu_torch.models.components_extra import AU_M, PC_M
        from pint_tpu_torch.models.components_tail import (
            solar_wind_geometry_host,
        )

        A = 10.0 ** self.TNSWAMP.value
        gamma = self.TNSWGAM.value
        nmodes = int(self.TNSWC.value or 10)
        t = _tdb_seconds(toas, ref_day=tref_day)
        F, freqs = create_fourier_design_matrix(t, nmodes, Tspan=tspan)
        # normalized at 90 degrees of elongation and 1 AU
        geom = solar_wind_geometry_host(toas, parent._host_psr_dir(toas))
        geom0 = (AU_M * AU_M / PC_M) * (np.pi / 2.0) / AU_M
        fscale = (self.REF_FREQ_MHZ / toas.get_freqs()) ** 2
        scale = (geom / geom0) * np.where(np.isfinite(fscale), fscale,
                                          0.0)
        F = F * scale[:, None]
        df = freqs[0]
        phi = powerlaw(freqs, A, gamma) * df
        return F, phi

    def noise_dm_basis(self, toas, F_time):
        """A nu^-2 DM perturbation (the geometry rides along in F_time):
        it couples into the wideband DM rows as PLDMNoise does."""
        return _dm_rows_from_time_basis(toas, F_time)
