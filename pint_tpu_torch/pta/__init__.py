"""Array-level likelihood plane (a port of pint_tpu/pta).

``pint_tpu_torch.pta`` treats the pulsar ARRAY, not a single pulsar, as
the unit of work:

- ``gwb``: the Hellings–Downs cross-correlated gravitational-wave-
  background likelihood — per-pulsar inner blocks from the SAME joint
  normal assembly the batch fit uses, a second-stage Schur complement
  over the (Npsr*m)^2 cross-correlated outer system, and a numpy mirror
  as the CPU oracle;
- ``metrics``: the plane's counters (``block_assemblies`` /
  ``hd_outer_solves`` / ``gwb_solves``);
- ``shard``: ``pad_batch``. Mesh compilation (``batch_sharding``,
  ``compile_with_plan``) is ROADMAP.md item 11.
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
from pint_tpu_torch.pta.shard import pad_batch  # noqa: F401

__all__ = [
    "GWBLikelihood", "PTAMetrics", "gwb_basis", "gwb_loglik_np",
    "gwb_phi", "hd_matrix", "pad_batch", "pulsar_positions",
]
