"""The fit step as one function of tensors (a port of the single-device
route of pint_tpu/parallel)."""

from pint_tpu_torch.parallel.fit_step import (  # noqa: F401
    build_fit_parts,
    build_fit_step,
)

__all__ = ["build_fit_step", "build_fit_parts"]
