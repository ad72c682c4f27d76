"""Runtime data directories (a copy of the three functions of
pint_tpu/config.py that the host modules call).

- $PINT_TPU_CLOCK_DIR   : directory of TEMPO/TEMPO2 clock files
- $PINT_TPU_EPHEM_DIR   : directory of SPK .bsp ephemeris kernels
- $PINT_TPU_OBS_OVERRIDE: JSON file overriding the observatory table
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["clock_dir", "ephem_dir", "obs_override"]


def clock_dir() -> Optional[Path]:
    d = os.environ.get("PINT_TPU_CLOCK_DIR")
    return Path(d) if d else None


def ephem_dir() -> Optional[Path]:
    d = os.environ.get("PINT_TPU_EPHEM_DIR")
    return Path(d) if d else None


def obs_override() -> Optional[Path]:
    d = os.environ.get("PINT_TPU_OBS_OVERRIDE")
    return Path(d) if d else None
