"""Fault-tolerant device dispatch, the runtime supervision layer (a
port of pint_tpu/runtime).

Every device call of the port routes through here, under the
reference's dispatch keys (``gls.fit_step``, ``gls.solve``,
``wls.solve``, ``stream.chunk``, ``pta.batch``, ``sampling.chain``, ...):

- ``runtime.supervisor``: the ``DispatchSupervisor`` — watchdog
  deadlines on a guarded worker, transient-error retry with jittered
  backoff, sticky-CUDA-error classification, host failover, RTT-drift
  re-measure + K re-pick, and the counters every snapshot embeds so
  degraded runs are labeled;
- ``runtime.breaker``: per-device circuit breaker (CLOSED/OPEN/
  HALF_OPEN, and LOST after a sticky CUDA error) with bounded
  subprocess re-probes;
- ``runtime.faults``: deterministic fault injection (hang, transient
  error, NaN output, RTT drift) at the dispatch boundary, so every
  behavior above is testable on the CPU;
- ``runtime.locks``: the lock factories and the lock-order graph.

Env knobs: $PINT_TPU_DISPATCH_DEADLINE_MS (hard deadline override),
$PINT_TPU_DISPATCH_RETRIES, $PINT_TPU_DISPATCH_BACKOFF_MS,
$PINT_TPU_DISPATCH_COMPILE_ALLOWANCE_MS, $PINT_TPU_BREAKER_THRESHOLD,
$PINT_TPU_BREAKER_COOLDOWN_S, $PINT_TPU_BREAKER_PROBE_TIMEOUT_S (see
``pint_tpu_torch.config``).
"""

from pint_tpu_torch.runtime.breaker import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    LOST,
    OPEN,
    CircuitBreaker,
)
from pint_tpu_torch.runtime.locks import (  # noqa: F401
    TracedLock,
    TracedRLock,
    make_condition,
    make_lock,
    make_rlock,
)
from pint_tpu_torch.runtime.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    FatalFault,
    TransientFault,
    active_plan,
)
from pint_tpu_torch.runtime.supervisor import (  # noqa: F401
    BackendUnavailable,
    DeviceLost,
    DispatchError,
    DispatchFuture,
    DispatchSupervisor,
    DispatchTimeout,
    RetriesExhausted,
    RuntimeMetrics,
    backend_of,
    bounded_backend_probe,
    breaker_for,
    get_supervisor,
    reset_runtime,
)
