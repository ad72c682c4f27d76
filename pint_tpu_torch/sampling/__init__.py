"""Posterior sampling on the device (a port of part of pint_tpu/sampling).

- ``sampling.kernel``: the affine-invariant stretch move (both
  half-ensemble updates, accept/reject, positional counter-based random
  streams) as a chunk of K steps over batched ensembles;
- ``sampling.serve_kernel``: the padded batch of linearized per-pulsar
  posteriors (``sample_problems``: every pulsar of a stacked array in one
  batch).

The noise-sampled likelihood, ``DevicePosterior``,
``DeviceEnsembleSampler`` and the MCMC fitters are still to port
(ROADMAP.md item 10).
"""

from pint_tpu_torch.sampling.kernel import build_stretch_chunk  # noqa: F401
from pint_tpu_torch.sampling.serve_kernel import (  # noqa: F401
    sample_problems,
)

__all__ = ["build_stretch_chunk", "sample_problems"]
