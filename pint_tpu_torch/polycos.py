"""Polynomial ephemerides ("polycos") for observatory folding (a port
of pint_tpu/polycos.py).

Reference: src/pint/polycos.py (Polycos.generate_polycos,
eval_abs_phase, eval_spin_freq, TEMPO polyco file I/O). A polyco block
predicts absolute pulse phase over a short segment as

    phase(T) = RPHASE + 60 F0 DT + C1 + C2 DT + ... + Cn DT^(n-1)

with DT = (T - TMID) in minutes (the TEMPO convention), so a telescope
backend can fold in real time without the full timing chain. The spin
frequency is the DT-derivative / 60.

The generator builds all segments' Chebyshev sample epochs as ONE TOAs
table on the host (one get_TOAs_array) and evaluates them in ONE
model.phase call on the device (the reference loops segments, re-running
astropy machinery per segment); the per-segment least-squares fits are
tiny host numpy solves. Phase samples come back to the host as dd, and
the large reference part RPHASE + 60 F0 DT is removed in exact dd before
the f64 fit, so ~1e10-turn absolutes never meet the polynomial algebra.
Evaluation and the TEMPO file format are host numpy; a PolycoEntry is
plain numpy and crosses between the packages as it is.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops import dd_np

__all__ = ["PolycoEntry", "Polycos"]

SECS_PER_DAY = 86400.0
MIN_PER_DAY = 1440.0


@dataclass
class PolycoEntry:
    """One polyco block (reference: polycos table row)."""

    psrname: str
    tmid: float                 # MJD (UTC, pulsar convention)
    rphase_int: float           # integer part of phase at TMID
    rphase_frac: float          # fractional part of phase at TMID
    f0: float                   # reference spin frequency [Hz]
    obs: str
    span_min: float
    coeffs: np.ndarray = field(default_factory=lambda: np.zeros(1))
    obsfreq_mhz: float = np.inf
    dm: float = 0.0

    def dt_min(self, mjds) -> np.ndarray:
        return (np.asarray(mjds, np.float64) - self.tmid) * MIN_PER_DAY

    def covers(self, mjds) -> np.ndarray:
        return np.abs(self.dt_min(mjds)) <= self.span_min / 2.0

    def abs_phase(self, mjds):
        """(int turns, frac turns) at the given MJDs — split so the
        ~1e10-turn absolute never loses the sub-turn part."""
        dt = self.dt_min(mjds)
        poly = np.polynomial.polynomial.polyval(dt, self.coeffs)
        # 60 F0 dt can reach ~1e7 turns over a span: split it
        spin = 60.0 * self.f0 * dt
        spin_i = np.floor(spin)
        frac = self.rphase_frac + (spin - spin_i) + poly
        carry = np.floor(frac)
        return (self.rphase_int + spin_i + carry), (frac - carry)

    def spin_freq(self, mjds) -> np.ndarray:
        """Apparent (topocentric) spin frequency [Hz]."""
        dt = self.dt_min(mjds)
        dcoef = np.polynomial.polynomial.polyder(self.coeffs)
        return self.f0 + np.polynomial.polynomial.polyval(
            dt, dcoef) / 60.0


class Polycos:
    """A set of polyco segments + evaluation and TEMPO-format I/O
    (reference: polycos.Polycos)."""

    def __init__(self, entries: Optional[List[PolycoEntry]] = None):
        self.entries = list(entries or [])

    # ------------------------------------------------- generation

    @classmethod
    def generate_polycos(cls, model, mjd_start: float, mjd_end: float,
                         obs: str, seg_length_min: float = 60.0,
                         ncoeff: int = 12, obsfreq_mhz: float = 1400.0,
                         device=None) -> "Polycos":
        """Fit ``ncoeff``-term blocks of ``seg_length_min`` minutes
        covering [mjd_start, mjd_end] for observatory ``obs``
        (reference: Polycos.generate_polycos). All segments' Chebyshev
        nodes are evaluated through ONE phase call on ``device`` (the
        model's when None)."""
        from pint_tpu_torch.toa import get_TOAs_array

        dev = model.device if device is None else resolve_device(device)
        if ncoeff < 2:
            raise ValueError("ncoeff must be >= 2")
        seg_d = seg_length_min / MIN_PER_DAY
        nseg = max(1, int(np.ceil((mjd_end - mjd_start) / seg_d)))
        tmids = mjd_start + (np.arange(nseg) + 0.5) * seg_d
        # Chebyshev nodes per segment (oversampled 2x for a stable LS)
        nnode = max(2 * ncoeff, ncoeff + 4)
        k = (np.arange(nnode) + 0.5) / nnode
        nodes = -np.cos(np.pi * k)          # (-1, 1)
        mjds = (tmids[:, None]
                + nodes[None, :] * seg_d / 2.0).ravel()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            toas = get_TOAs_array(
                mjds, obs=obs, freqs=obsfreq_mhz, errors=1.0,
                ephem=model.EPHEM.value,
                planets=bool(model.PLANET_SHAPIRO.value), device=dev)
            ph = model.phase(toas, abs_phase=True, device=dev).turns
        ph = (ph.hi.cpu().numpy(), ph.lo.cpu().numpy())
        f0 = float(model.F0.value)
        try:
            dm = float(model.get_param("DM").value or 0.0)
        except KeyError:
            dm = 0.0
        psr = str(model.PSR.value or "PSR")
        entries = []
        for s in range(nseg):
            sl = slice(s * nnode, (s + 1) * nnode)
            seg_ph = (ph[0][sl], ph[1][sl])
            dt_min = (mjds[sl] - tmids[s]) * MIN_PER_DAY
            # reference part RPHASE + 60 F0 DT removed in exact dd
            tmid_idx = np.argmin(np.abs(dt_min))
            ref = dd_np.add_f(
                dd_np.mul_f(dd_np.dd(dt_min), 60.0 * f0), 0.0)
            resid = dd_np.sub(seg_ph, ref)
            # RPHASE = phase at TMID: interpolate the residual's int
            # level from the node nearest TMID (the residual varies by
            # << 1 turn per minute there)
            r0 = dd_np.to_f64(
                (resid[0][tmid_idx], resid[1][tmid_idx]))
            rphase_int = np.floor(r0)
            y = dd_np.to_f64(resid) - rphase_int
            # least squares in a scaled variable for conditioning,
            # then map back to monomials in DT
            half_min = seg_length_min / 2.0
            x = dt_min / half_min
            V = np.polynomial.chebyshev.chebvander(x, ncoeff - 1)
            c_cheb, *_ = np.linalg.lstsq(V, y, rcond=None)
            c_x = np.polynomial.chebyshev.cheb2poly(c_cheb)
            scale = half_min ** -np.arange(len(c_x))
            coeffs = c_x * scale
            # the fractional reference phase rides in coeffs[0];
            # rphase_frac stays 0 so there is exactly one home for it
            entries.append(PolycoEntry(
                psrname=psr, tmid=float(tmids[s]),
                rphase_int=float(rphase_int), rphase_frac=0.0,
                f0=f0, obs=obs, span_min=float(seg_length_min),
                coeffs=coeffs, obsfreq_mhz=float(obsfreq_mhz),
                dm=dm))
        return cls(entries)

    # ------------------------------------------------- evaluation

    def _entry_for(self, mjds) -> np.ndarray:
        tmids = np.array([e.tmid for e in self.entries])
        idx = np.argmin(
            np.abs(np.asarray(mjds, np.float64)[:, None]
                   - tmids[None, :]), axis=1)
        return idx

    def eval_abs_phase(self, mjds):
        """(int, frac) absolute phase at each MJD (reference:
        Polycos.eval_abs_phase)."""
        mjds = np.atleast_1d(np.asarray(mjds, np.float64))
        idx = self._entry_for(mjds)
        pi = np.zeros(len(mjds))
        pf = np.zeros(len(mjds))
        for s in np.unique(idx):
            m = idx == s
            a, b = self.entries[s].abs_phase(mjds[m])
            pi[m], pf[m] = a, b
        return pi, pf

    def eval_spin_freq(self, mjds) -> np.ndarray:
        """Apparent spin frequency [Hz] (reference:
        Polycos.eval_spin_freq)."""
        mjds = np.atleast_1d(np.asarray(mjds, np.float64))
        idx = self._entry_for(mjds)
        out = np.zeros(len(mjds))
        for s in np.unique(idx):
            m = idx == s
            out[m] = self.entries[s].spin_freq(mjds[m])
        return out

    # ------------------------------------------------- TEMPO format

    @staticmethod
    def _fmt_d(x: float) -> str:
        """Fortran D-exponent float, TEMPO polyco style."""
        s = f"{x: .17e}"
        return s.replace("e", "D")

    def write_polyco_file(self, path: str):
        """TEMPO polyco.dat layout (reference:
        Polycos.write_polyco_file): header line (name, date, utc,
        tmid, dm), data line (rphase, f0, obs, span, ncoeff,
        obsfreq), then coefficients three per line with D
        exponents."""
        with open(path, "w") as f:
            for e in self.entries:
                rph = e.rphase_int + e.rphase_frac + e.coeffs[0]
                # TMID carries 15 decimals (TEMPO's classic 11 would
                # quantize at ~0.4 us, i.e. ~1e-4 turns at 218 Hz —
                # whitespace-tolerant parsers read either)
                f.write(f"{e.psrname:<10s} {'':9s}{'':7s}"
                        f"{e.tmid:24.15f}{e.dm:21.6f}\n")
                f.write(f"{rph:20.6f}{e.f0:18.12f}"
                        f"{e.obs:>5s}{int(e.span_min):5d}"
                        f"{len(e.coeffs):5d}{e.obsfreq_mhz:10.3f}\n")
                for i in range(0, len(e.coeffs), 3):
                    row = e.coeffs[i:i + 3].copy()
                    if i == 0:
                        row = row.copy()
                        row[0] = 0.0  # folded into RPHASE above
                    f.write("".join(f"{self._fmt_d(c):>25s}"
                                    for c in row) + "\n")

    @classmethod
    def read_polyco_file(cls, path: str) -> "Polycos":
        """Inverse of write_polyco_file."""
        entries = []
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        i = 0
        while i < len(lines):
            h = lines[i].split()
            psr = h[0]
            tmid = float(h[-2])
            dm = float(h[-1])
            d = lines[i + 1].split()
            rph = float(d[0])
            f0 = float(d[1])
            obs = d[2]
            span = float(d[3])
            nco = int(d[4])
            obsfreq = float(d[5])
            nrows = (nco + 2) // 3
            vals: List[float] = []
            for r in range(nrows):
                for tok in lines[i + 2 + r].split():
                    vals.append(float(tok.replace("D", "e")))
            coeffs = np.asarray(vals[:nco])
            rint = np.floor(rph)
            coeffs = coeffs.copy()
            coeffs[0] = coeffs[0] + (rph - rint)
            entries.append(PolycoEntry(
                psrname=psr, tmid=tmid, rphase_int=float(rint),
                rphase_frac=0.0, f0=f0, obs=obs, span_min=span,
                coeffs=coeffs, obsfreq_mhz=obsfreq, dm=dm))
            i += 2 + nrows
        return cls(entries)
