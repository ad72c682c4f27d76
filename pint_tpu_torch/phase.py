"""Pulse-phase bookkeeping (a port of pint_tpu/phase.py).

A phase is a ``DD`` of turns; ``Phase`` exposes the reference's (int,
frac) decomposition (src/pint/phase.py Phase) so ~1e10 turns of absolute
phase never eat the sub-ns fractional part.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pint_tpu_torch.ops.dd import DD, dd_frac, dd_round, dd_to_f64


class Phase(NamedTuple):
    """Absolute pulse phase in turns, carried as DD."""

    turns: DD

    @property
    def int(self) -> torch.Tensor:
        """Nearest-integer pulse number (f64-exact up to 2^53 turns)."""
        return dd_round(self.turns).hi

    @property
    def frac(self) -> torch.Tensor:
        """Signed fractional phase in [-0.5, 0.5] turns (f64)."""
        return dd_to_f64(dd_frac(self.turns))
