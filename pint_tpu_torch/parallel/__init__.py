"""The fit step as one function of tensors, the downhill loop over it,
the streaming accumulator and the pulsar-array batch solve (a port of the
single-device route of pint_tpu/parallel)."""

from pint_tpu_torch.parallel.fit_step import (  # noqa: F401
    build_fit_loop,
    build_fit_parts,
    build_fit_step,
)
from pint_tpu_torch.parallel.pta import (  # noqa: F401
    build_problem,
    fit_pta,
    pta_solve,
    stack_problems,
)
from pint_tpu_torch.parallel.streaming import StreamingGLS  # noqa: F401

__all__ = ["build_fit_step", "build_fit_parts", "build_fit_loop",
           "StreamingGLS", "build_problem", "fit_pta", "pta_solve",
           "stack_problems"]
