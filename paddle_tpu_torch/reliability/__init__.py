"""``paddle_tpu_torch.reliability`` — the fault-tolerance layer, the port's
copy of ``paddle_tpu/reliability`` (pure stdlib):

  * :mod:`~paddle_tpu_torch.reliability.faults` — a seeded, deterministic
    fault-injection harness (``PADDLE_TPU_FAULTS`` env var or an
    explicit :class:`FaultPlan`). Recovery paths are tested against
    injected failures, not hoped-for.
  * :mod:`~paddle_tpu_torch.reliability.policy` — composable
    :class:`RetryPolicy` (exponential backoff + deterministic jitter,
    injectable sleep), :class:`CircuitBreaker` and :class:`Deadline`.

Consumers: ``serving.ServingEngine`` (replica circuit breakers,
supervisor, cross-replica batch retry, the swap sites) and the
multi-process front door (``serving/rpc.py``, ``worker.py``,
``router.py``).
"""

from .faults import (FaultPlan, FaultSpec, InjectedFault,  # noqa: F401
                     active_plan, corrupt_bytes, fault_scope, trip)
from .policy import (CircuitBreaker, Deadline,  # noqa: F401
                     DeadlineExpired, RetryError, RetryPolicy)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "active_plan",
    "corrupt_bytes", "fault_scope", "trip",
    "RetryPolicy", "RetryError", "CircuitBreaker", "Deadline",
    "DeadlineExpired",
]
