"""The fit step as one function of tensors, the downhill loop over it,
the streaming accumulator and the pulsar-array batch solve, on one device
or over a device mesh (a port of pint_tpu/parallel): the TOA axis split
over the mesh in ``build_sharded_fit_step``, the pulsar axis in
``pta_solve(mesh=)`` and ``fit_pta(mesh=)``."""

from pint_tpu_torch.parallel.fit_step import (  # noqa: F401
    build_fit_loop,
    build_fit_parts,
    build_fit_step,
    build_sharded_fit_step,
    toa_sharding,
)
from pint_tpu_torch.parallel.pta import (  # noqa: F401
    build_problem,
    fit_pta,
    pta_solve,
    stack_problems,
)
from pint_tpu_torch.parallel.streaming import StreamingGLS  # noqa: F401

__all__ = ["build_fit_step", "build_fit_parts", "build_fit_loop",
           "build_sharded_fit_step", "toa_sharding", "StreamingGLS", "build_problem", "fit_pta", "pta_solve",
           "stack_problems"]
