"""The work the photon chain's stages need, and the least time the card
could take for it (the card's peaks are ``roofline.PEAKS``).

The counts are of the work the results need, whatever implements it, so
that a later fused likelihood kernel is read by the same yardstick:
float64 operations with a fused multiply-add as two and exp and log as
one each (the card evaluates each with many; counting them as one keeps
the least time a lower bound), and each input byte read once and each
output byte written once.

A walker's log-likelihood over one photon needs, given the photon's
delay-corrected time dt as a double-double:

- the spin phase dt (F0 + dt F1 / 2) in double-double: two products
  (10 operations each: the high product, its error by a fused
  multiply-add, the cross terms, a renormalization) and a sum (11: a
  two-sum, the low words, a renormalization);
- the wrap to a fraction of a turn: 4;
- three wrapped Gaussians, each over 7 images: per image the offset and
  the scale (2), the square and the half (2), the exp (1) and the
  accumulation (1); then the norm over the width, and the sum: 3;
- the background and the log, and the sum over photons: 3.

Shared by the walkers of a batch, once a photon: the Sun's Shapiro delay
(its distance: 5, the projection on the pulsar: 5, the log and the
scale: 4) and dt from the TDB less PEPOCH and the delay (two
double-double differences, 11 each). A batch reads the photon columns
the phase needs once: the TDB as a double-double (16 B) and the Sun's
position (24 B); each walker writes one float64 log L.

K1 (the H-test's harmonic sums, ``ops/z2_harmonics.py``) is bounded by
its bytes, 16 a photon (float64 phases and weights) at the memory
bandwidth, as the port's kernel table gives; its operations, 9 a
photon and harmonic at the float32 rate, take less.
"""

from __future__ import annotations

from portbench.roofline import F64, PEAKS

F32_FLOPS = 67e12          # NVIDIA H100 SXM, float32 outside the tensor cores

DD_MUL = 10
DD_ADD = 11
SPIN_PHASE = 2 * DD_MUL + DD_ADD
WRAP = 4
IMAGES = 7
IMAGE = 6
GAUSSIAN = IMAGES * IMAGE + 3
TAIL = 3
SHAPIRO = 14
PHOTON_FLOPS = SHAPIRO + 2 * DD_ADD
PHOTON_BYTES = 16 + 24
Z2_BYTES = 16
Z2_FLOPS = 9


def walker_photon_flops(ngauss: int = 3) -> int:
    """Float64 operations of one walker's log-likelihood term of one
    photon."""
    return SPIN_PHASE + WRAP + ngauss * GAUSSIAN + TAIL


def lnlike_least_s(photons: int, walker_evals: int, batches: int,
                   ngauss: int = 3) -> float:
    """The least time for ``walker_evals`` walker log-likelihoods over
    ``photons`` photons issued in ``batches`` equal batches: per batch
    the larger of its operations at the float64 rate and its bytes at
    the memory bandwidth."""
    w = walker_evals / batches
    flops = w * photons * walker_photon_flops(ngauss) \
        + photons * PHOTON_FLOPS
    nbytes = photons * PHOTON_BYTES + w * F64
    return batches * max(flops / PEAKS["f64_flops"],
                         nbytes / PEAKS["hbm_bytes_per_s"])


def z2_least_s(photons: int, m: int) -> float:
    """The least time for one H-test's harmonic sums (K1) over
    ``photons`` photons and ``m`` harmonics."""
    return max(photons * Z2_BYTES / PEAKS["hbm_bytes_per_s"],
               photons * m * Z2_FLOPS / F32_FLOPS)
