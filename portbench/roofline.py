"""Peaks of the card and the work each measured stage needs.

The counts are of the work that the asked-for results need, whatever
implements it: a later kernel that factors fewer padded systems, or
replaces cuSOLVER, is read by the same yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
# Float64 runs at 67 TFLOP/s on the tensor cores (DGEMM-like work) and at
# 34 TFLOP/s outside them.
PEAKS = {
    "f64_tensor_flops": 67e12,
    "f64_flops": 34e12,
    "hbm_bytes_per_s": 3.35e12,
}
F64 = 8


def gwb_outer_flops(npulsars: int, m: int) -> float:
    """Floating-point operations of one GWB point's outer stage, with
    n = P m: the Cholesky factorization of the (n, n) Schur system
    (n^3 / 3) and the solve for its quadratic form (2 n^2)."""
    n = npulsars * m
    return n ** 3 / 3.0 + 2.0 * n ** 2


def gwb_outer_bytes(npulsars: int, m: int) -> float:
    """Bytes one GWB point's outer stage must move: its inputs read once
    (the blocks A (P, m, m), x (P, m), Gamma (P, P) and the point's two
    coordinates) and its log-likelihood written once."""
    P = npulsars
    return F64 * (P * m * m + P * m + P * P + 2 + 1)


def gwb_outer_least_s(npulsars: int, m: int, points: int) -> float:
    """The least time the card could take for ``points`` points: the
    larger of their flops at the float64 tensor-core rate and their bytes
    at the memory bandwidth."""
    return points * max(
        gwb_outer_flops(npulsars, m) / PEAKS["f64_tensor_flops"],
        gwb_outer_bytes(npulsars, m) / PEAKS["hbm_bytes_per_s"])
