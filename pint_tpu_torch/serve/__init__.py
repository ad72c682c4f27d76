"""Shape-bucketed batch serving layer (a port of pint_tpu/serve).

The moving parts (one module each, the reference's names):

- ``serve.request``: typed requests (fit step / residuals / phase
  prediction / posterior sampling / TOA append / array GWB sweeps)
  with deadlines and result futures;
- ``serve.bucket``: power-of-two shape-class bucketing + the
  per-engine class-program registry (the batched torch programs);
- ``serve.append``: per-pulsar accumulated normal equations and the
  batched append rank update;
- ``serve.scheduler``: the coalescing ServeEngine (admission queue,
  window batching, backpressure, pipelined drain) and the
  ``Fitter.auto(serve=...)``-routed fitter;
- ``serve.metrics``: per-bucket occupancy / waste / latency / class
  counters, plus the engine's dispatch-supervisor counters;
- ``serve.workload``: the synthetic mixed-shape workload builder;
- ``serve.admission``: per-tenant token-bucket quotas, deadline-aware
  load shedding, in-queue deadline expiry — every shed labeled;
- ``serve.router``: breaker-aware capacity routing over the card
  ("device", breaker "cuda:0") and the host CPU ("host") as concurrent
  pools with learned service rates;
- ``serve.journal``: crash-safe restart — append-only request journal
  with replay, the warm-restart class store, serve-state snapshot;
- ``serve.fleet``: N workers over one journal-as-replicated-log —
  leases, fencing, re-homing of a dead worker's unacknowledged admits.

Every device dispatch routes through the engine's
``runtime.DispatchSupervisor`` (watchdog deadline, circuit breaker,
host failover). Entry point: ``scripts/pint_serve.py`` (stdin JSONL
daemon).
"""

from pint_tpu_torch.serve.request import (  # noqa: F401
    AppendResult,
    AppendTOAsRequest,
    DeadlineExceeded,
    EngineKilled,
    FitStepRequest,
    FitStepResult,
    GWBRequest,
    GWBResult,
    PhasePredictRequest,
    PhasePredictResult,
    PosteriorRequest,
    PosteriorResult,
    ResidualsRequest,
    ResidualsResult,
    ServeFuture,
    ServeOverload,
    ShutdownShed,
    StateMissing,
    TenantOverQuota,
)
from pint_tpu_torch.serve.append import (  # noqa: F401
    AppendStore,
    build_append_rows,
)
from pint_tpu_torch.serve.scheduler import (  # noqa: F401
    ServeEngine,
    ServeGLSFitter,
)
from pint_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from pint_tpu_torch.serve.bucket import (  # noqa: F401
    ExecutableCache,
    bucket_for,
    pow2_ceil,
)
from pint_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    TokenBucket,
)
from pint_tpu_torch.serve.router import CapacityRouter  # noqa: F401
from pint_tpu_torch.serve.journal import (  # noqa: F401
    AotStore,
    RequestJournal,
)
from pint_tpu_torch.serve.fleet import (  # noqa: F401
    FleetFront,
    FleetWorker,
    WorkerLease,
)
