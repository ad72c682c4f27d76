"""Posterior sampling on the device (a port of pint_tpu/sampling).

- ``sampling.kernel``: the affine-invariant stretch move (both
  half-ensemble updates, accept/reject, positional counter-based random
  streams) as a chunk of K steps over batched ensembles;
- ``sampling.likelihood``: GP noise-hyperparameter sampling —
  PLRedNoise log10_A/gamma and ECORR weights as sampled dimensions (phi,
  the per-epoch variances, the Sff Cholesky and the logdet recomputed
  per walker; arXiv:1202.5932 via the arXiv:1407.6710 low-rank Woodbury
  split);
- ``sampling.posterior``: ``DevicePosterior`` — priors + likelihood as
  one (W, ndim) -> (W,) batch function (``torch.func.vmap`` over the
  walkers), fixed-noise or noise-sampled;
- ``sampling.chain``: ``DeviceEnsembleSampler`` — chunked whole-chain
  runs, with a ``host_loop`` mode on the identical positional random
  streams as the bit-equality oracle;
- ``sampling.serve_kernel``: the padded batch of linearized per-pulsar
  posteriors (``sample_problems``: every pulsar of a stacked array in one
  batch).

``mcmc_fitter.MCMCFitter`` is a thin consumer of this package.
"""

from pint_tpu_torch.sampling.chain import DeviceEnsembleSampler  # noqa: F401
from pint_tpu_torch.sampling.kernel import build_stretch_chunk  # noqa: F401
from pint_tpu_torch.sampling.likelihood import (  # noqa: F401
    SampledNoiseLikelihood,
)
from pint_tpu_torch.sampling.posterior import DevicePosterior  # noqa: F401
from pint_tpu_torch.sampling.serve_kernel import (  # noqa: F401
    sample_problems,
)

__all__ = ["DeviceEnsembleSampler", "DevicePosterior",
           "SampledNoiseLikelihood", "build_stretch_chunk",
           "sample_problems"]
