"""The fit step as one function of tensors, the downhill loop over it,
and the streaming accumulator (a port of the single-device route of
pint_tpu/parallel)."""

from pint_tpu_torch.parallel.fit_step import (  # noqa: F401
    build_fit_loop,
    build_fit_parts,
    build_fit_step,
)

__all__ = ["build_fit_step", "build_fit_parts", "build_fit_loop"]
