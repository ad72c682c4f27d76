"""Plain reference of the Hellings-Downs correlated GWB likelihood.

The array's covariance is C = blockdiag(D_a) + U (Gamma (x) diag(phi)) U^T,
where pulsar a's own covariance D_a = N_a + F_a diag(phi_a) F_a^T has its
timing model M_a marginalized under a flat prior, U_a is a Fourier basis
of ``nfreq`` bins on the array's common span, phi the power-law weights
of the common process and Gamma the Hellings-Downs matrix of the sky
positions (van Haasteren and Vallisneri 2014, arXiv:1407.1838; Agazie et
al. 2023, ApJL 951, L8). With the Woodbury identity, for each pulsar

    A_a = U_a^T D_a^-1 U_a,  x_a = U_a^T D_a^-1 r_a,
    rdr_a = r_a^T D_a^-1 r_a,  ld_a = logdet D_a  (flat-prior constant dropped)

and for each point S = Gamma^-1 (x) diag(1/phi) + blockdiag(A_a), factored
at a unit diagonal:

    log L = -1/2 [sum rdr - x^T S^-1 x + sum ld + m logdet Gamma
                  + P sum log phi + logdet S].

Plain torch in the dtype asked for, one pulsar at a time and one dense
factorization a point. It takes the benchmark's inputs (TOA epochs,
design, noise, residuals, sky positions) and nothing the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SECONDS_PER_DAY = 86400.0
F_YEAR = 1.0 / (365.25 * SECONDS_PER_DAY)


def powerlaw_weights(freqs, log10_A, gamma, tspan):
    """Prior variance [s^2] of each sin and cos coefficient of a power-law
    process, A^2/(12 pi^2) f_yr^(gamma-3) f^-gamma, times the bin width
    1/T, taken through its logarithm so that no factor leaves the range
    of the dtype."""
    log_w = 2.0 * math.log(10.0) * log10_A - math.log(12.0 * math.pi ** 2) \
        + (gamma - 3.0) * math.log(F_YEAR) - math.log(tspan)
    return torch.exp(log_w - gamma * torch.log(freqs))


def fourier_basis(t, nfreq, tspan):
    """(N, 2 nfreq) columns sin(2 pi f_k t), cos(2 pi f_k t), f_k = k/T,
    and each column's frequency."""
    f = torch.arange(1, nfreq + 1, dtype=t.dtype, device=t.device) / tspan
    arg = 2.0 * math.pi * t[:, None] * f[None, :]
    out = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return out.reshape(len(t), 2 * nfreq), f.repeat_interleave(2)


def epoch_seconds(inputs):
    """Each pulsar's TOA times [s] from the array's earliest TOA day, and
    the array's common span [s]."""
    day0 = min(float(np.min(d)) for d in inputs["mjd_day"])
    ts = [((d - day0) + hi + lo) * SECONDS_PER_DAY
          for d, hi, lo in zip(inputs["mjd_day"], inputs["mjd_frac_hi"],
                               inputs["mjd_frac_lo"])]
    tspan = max(t.max() for t in ts) - min(t.min() for t in ts)
    return ts, float(tspan)


def hellings_downs(positions):
    """Gamma_ab = 3/2 x ln x - x/4 + 1/2 with x = (1 - cos zeta_ab)/2, and
    1 on the diagonal (the pulsar term)."""
    p = positions / torch.linalg.norm(positions, dim=1, keepdim=True)
    x = (1.0 - torch.clamp(p @ p.T, -1.0, 1.0)) / 2.0
    g = 1.5 * x * torch.log(torch.where(x > 0, x, torch.ones_like(x))) \
        - x / 4.0 + 0.5
    g.fill_diagonal_(1.0)
    return g


def pulsar_terms(M, F, phi, r, nvec, U):
    """(A, x, rdr, ld) of one pulsar. The columns of [M F] are scaled to
    unit weighted norm before the factorization, and the scale is put
    back into the log-determinant."""
    w = 1.0 / nvec
    T = torch.cat([M, F], dim=1)
    s = torch.sqrt(torch.sum(T * T * w[:, None], dim=0))
    Ts = T / s
    p = M.shape[1]
    prior = torch.cat([torch.zeros(p, dtype=T.dtype, device=T.device),
                       1.0 / (phi * s[p:] ** 2)])
    Sig = Ts.T @ (Ts * w[:, None]) + torch.diag(prior)
    L = torch.linalg.cholesky(Sig)
    Uw = U * w[:, None]
    Z = torch.linalg.solve_triangular(L, Ts.T @ Uw, upper=False)
    z = torch.linalg.solve_triangular(L, (Ts.T @ (w * r))[:, None],
                                      upper=False)[:, 0]
    A = U.T @ Uw - Z.T @ Z
    x = Uw.T @ r - Z.T @ z
    rdr = torch.sum(w * r * r) - torch.sum(z * z)
    ld = torch.sum(torch.log(nvec)) + torch.sum(torch.log(phi)) \
        + 2.0 * torch.sum(torch.log(torch.diagonal(L))) \
        + 2.0 * torch.sum(torch.log(s))
    return A, x, rdr, ld


def prepare(inputs, device, dtype=torch.float64):
    """Everything that does not depend on (log10 A, gamma): the common
    basis, Gamma and each pulsar's terms, in ``dtype`` on ``device``."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device).to(dtype)

    ts, tspan = epoch_seconds(inputs)
    nfreq = int(inputs["nfreq"])
    A, x, rdr, ld = [], [], 0.0, 0.0
    for k, t in enumerate(ts):
        U, freqs = fourier_basis(put(t), nfreq, tspan)
        a, xa, ra, la = pulsar_terms(
            put(inputs["M"][k]), put(inputs["F"][k]),
            put(inputs["phi"][k]), put(inputs["r"][k]),
            put(inputs["nvec"][k]), U)
        A.append(a)
        x.append(xa)
        rdr = rdr + ra
        ld = ld + la
    Gamma = hellings_downs(put(inputs["positions"]))
    return {"A": torch.stack(A), "x": torch.stack(x), "rdr": rdr,
            "ld": ld, "Gamma": Gamma, "freqs": freqs, "tspan": tspan}


def loglik(state, log10_A, gamma):
    """log L at each point (numpy arrays of log10 A and gamma); NaN
    where the Schur system does not factor in the dtype."""
    A, x, Gamma = state["A"], state["x"], state["Gamma"]
    P, m = x.shape
    LG = torch.linalg.cholesky(Gamma)
    Ginv = torch.cholesky_inverse(LG)
    ldG = 2.0 * torch.sum(torch.log(torch.diagonal(LG)))
    xs = x.reshape(P * m)
    out = np.zeros(len(log10_A))
    for k, (la, ga) in enumerate(zip(log10_A, gamma)):
        phi = powerlaw_weights(state["freqs"], float(la), float(ga),
                               state["tspan"])
        # S[(a, i), (b, j)] = Ginv[a, b] delta_ij / phi_i + delta_ab A_a[i, j]
        S4 = Ginv[:, None, :, None] * torch.diag(1.0 / phi)[None, :, None, :]
        for a in range(P):
            S4[a, :, a, :] += A[a]
        S = S4.reshape(P * m, P * m)
        # factor S scaled to a unit diagonal; the scale goes back into
        # the quadratic form and the log-determinant
        d = torch.sqrt(torch.diagonal(S))
        L, info = torch.linalg.cholesky_ex(S / (d[:, None] * d[None, :]))
        if int(info) != 0:
            out[k] = math.nan  # no factorization: no value at this point
            continue
        y = torch.linalg.solve_triangular(L, (xs / d)[:, None], upper=False)
        ldS = 2.0 * torch.sum(torch.log(torch.diagonal(L))) \
            + 2.0 * torch.sum(torch.log(d))
        val = -0.5 * (state["rdr"] - torch.sum(y * y) + state["ld"]
                      + m * ldG + P * torch.sum(torch.log(phi)) + ldS)
        out[k] = float(val)
    return out
