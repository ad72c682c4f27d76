"""pint_tpu_torch — the PyTorch/CUDA port of pint_tpu.

The same pulsar-timing pipeline as ``pint_tpu`` (the JAX package beside
it, which stays the reference), written for PyTorch on an NVIDIA GPU:

- host modules (par/tim/FITS parsing, time scales, observatories,
  ephemerides, parameters) are plain numpy, copied from the reference;
- time and phase are double-double (two-float64) torch tensors
  (``pint_tpu_torch.ops.dd``), evaluated eagerly on the device;
- the one hand-written kernel so far, the Z^2_m harmonic sums behind the
  H-test, is CUDA C++ for sm_90a (``pint_tpu_torch/csrc``).

Every tensor on the phase path is float64; the global default dtype is
never changed. Entry points take ``device=None``, which means the GPU
("cuda"): asking for it without one raises instead of running on the CPU
quietly. Pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Physical constants (SI unless noted), as in pint_tpu/__init__.py.
c_m_s = 299_792_458.0  # speed of light, exact
AU_m = 1.495_978_707_00e11  # astronomical unit, IAU 2012 exact
pc_m = 3.085_677_581_49e16  # parsec
Tsun_s = 4.925_490_947e-6  # GM_sun/c^3 [s] — solar Shapiro scale
GMsun_m3_s2 = 1.327_124_400_18e20

# Dispersion constant, TEMPO convention (exact 1/2.41e-4), NOT the physical
# 4148.808 value — kept for .par compatibility
# (reference: src/pint/__init__.py DMconst).
DMconst = 1.0 / 2.41e-4  # s MHz^2 pc^-1 cm^3

SECS_PER_DAY = 86400.0
MJD_J2000 = 51544.5  # TT epoch J2000.0 as MJD
light_second_m = c_m_s  # 1 lt-s in meters


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on. ``None`` means "cuda";
    a CUDA device without a GPU raises RuntimeError (never a quiet
    fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
