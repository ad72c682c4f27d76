"""Pulse-phase bookkeeping (a port of pint_tpu/phase.py).

A phase is a ``DD`` of turns; ``Phase`` exposes the reference's (int,
frac) decomposition (src/pint/phase.py Phase) so ~1e10 turns of absolute
phase never eat the sub-ns fractional part.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops.dd import (
    DD,
    dd_add,
    dd_frac,
    dd_neg,
    dd_round,
    dd_sub,
    dd_to_f64,
)


def _as_dd(x, device=None) -> DD:
    """``x`` as a DD: a DD as it is, a tensor as its high word (on its
    own device), anything else as a float64 tensor on ``device`` (None
    means "cuda")."""
    if isinstance(x, DD):
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float64,
                            device=resolve_device(device))
    return DD(x, torch.zeros_like(x))


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

    @property
    def frac_dd(self) -> DD:
        """The signed fractional phase as a DD."""
        return dd_frac(self.turns)

    def __add__(self, other):
        other = other.turns if isinstance(other, Phase) \
            else _as_dd(other, self.turns.hi.device)
        return Phase(dd_add(self.turns, other))

    def __sub__(self, other):
        other = other.turns if isinstance(other, Phase) \
            else _as_dd(other, self.turns.hi.device)
        return Phase(dd_sub(self.turns, other))

    def __neg__(self):
        return Phase(dd_neg(self.turns))


def phase_from_f64(x, device=None) -> Phase:
    """A Phase from float64 turns: a tensor stays on its device, other
    values go to ``device`` (None means "cuda")."""
    return Phase(_as_dd(x, device))
