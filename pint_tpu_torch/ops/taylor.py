"""Taylor-series evaluation (a port of pint_tpu/ops/taylor.py).

``taylor_horner(dt, [c0, c1, c2, ...]) = c0 + c1 dt + c2 dt^2/2! + ...``
is the spindown phase engine of the reference
(src/pint/utils.py taylor_horner; src/pint/models/spindown.py):

- ``taylor_horner``/``taylor_horner_deriv``: plain Horner in the dtype
  of ``dt`` (delays, DM, their time derivatives);
- ``dd_taylor_horner``: double-double accumulator (absolute pulse phase,
  where F0*dt is ~1e10 turns and must keep <1e-9 turn error).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from pint_tpu_torch.ops.dd import DD, dd_add, dd_add_f, dd_div_f, dd_mul, \
    operand


def taylor_horner(dt: torch.Tensor, coeffs: Sequence):
    """Sum_i coeffs[i] * dt^i / i! via Horner (coeffs: floats or 0-d
    tensors)."""
    return taylor_horner_deriv(dt, coeffs, deriv_order=0)


def taylor_horner_deriv(dt: torch.Tensor, coeffs: Sequence,
                        deriv_order: int = 1):
    """deriv_order-th derivative of taylor_horner with respect to dt."""
    n = len(coeffs)
    if n <= deriv_order:
        return torch.zeros_like(dt)
    # the derivative shifts the series: sum_{i>=d} c_i dt^{i-d}/(i-d)!
    acc = torch.zeros_like(dt)
    for i in reversed(range(deriv_order, n)):
        ci = coeffs[i]
        if not torch.is_tensor(ci):
            ci = float(ci)
        acc = acc * dt + ci / math.factorial(i - deriv_order)
    return acc


def dd_taylor_horner(dt: DD, coeffs: Sequence) -> DD:
    """Sum_i coeffs[i] * dt^i / i! with a double-double accumulator.

    ``dt`` is DD (seconds since epoch); each coefficient is a DD (F0 and
    friends keep their par-file digits) or a plain number."""
    z = torch.zeros_like(dt.hi)
    acc = DD(z, z)
    for i in reversed(range(len(coeffs))):
        ci = coeffs[i]
        fct = float(math.factorial(i))
        acc = dd_mul(acc, dt)
        if isinstance(ci, DD):
            acc = dd_add(acc, dd_div_f(ci, fct) if fct != 1.0 else ci)
        else:
            acc = dd_add_f(acc, operand(ci, dt.hi) / fct)
    return acc
