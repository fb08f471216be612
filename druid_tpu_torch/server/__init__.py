"""Query admission, cancellation and deadlines: what the broker needs of
the reference package's `server/`. The HTTP resource, the data-node
scheduler, the router, security, the lifecycle and subscriptions come with
the HTTP serving slice."""
from druid_tpu_torch.server.deadline import Deadline, context_timeout_ms
from druid_tpu_torch.server.querymanager import (QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryManager, QueryScheduler,
                                                 QueryTimeoutError, QueryToken)

__all__ = ["Deadline", "context_timeout_ms", "QueryManager",
           "QueryScheduler", "QueryToken", "QueryInterruptedError",
           "QueryTimeoutError", "QueryCapacityError"]
