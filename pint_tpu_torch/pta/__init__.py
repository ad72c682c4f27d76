"""Array-level likelihood plane (a port of pint_tpu/pta).

``pint_tpu_torch.pta`` treats the pulsar ARRAY, not a single pulsar, as
the unit of work:

- ``gwb``: the Hellings–Downs cross-correlated gravitational-wave-
  background likelihood — per-pulsar inner blocks from the SAME joint
  normal assembly the batch fit uses, a second-stage Schur complement
  over the (Npsr*m)^2 cross-correlated outer system, each stage a
  supervised dispatch with the numpy mirror as its host failover (and
  the CPU oracle);
- ``metrics``: the plane's registry-backed counters
  (``block_assemblies`` / ``hd_outer_solves`` / ``gwb_solves``);
- ``shard``: the device mesh (``Mesh``) and the block plan of a batch
  kernel over it (``batch_sharding``, ``compile_with_plan``,
  ``pad_batch``): one process issues each contiguous block of pulsars
  on its device.
"""

from pint_tpu_torch.pta.gwb import (  # noqa: F401
    GWBLikelihood,
    gwb_basis,
    gwb_loglik_np,
    gwb_phi,
    hd_matrix,
    pulsar_positions,
)
from pint_tpu_torch.pta.metrics import PTAMetrics  # noqa: F401
from pint_tpu_torch.pta.shard import Mesh, pad_batch  # noqa: F401

__all__ = [
    "GWBLikelihood", "Mesh", "PTAMetrics", "gwb_basis", "gwb_loglik_np",
    "gwb_phi", "hd_matrix", "pad_batch", "pulsar_positions",
]
