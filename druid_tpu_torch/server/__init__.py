"""The query resource and what stands around it: the HTTP server
(QueryHttpServer, with /druid/v2/sql and Avatica over a SqlExecutor), the
router in front of the brokers (RouterHttpServer, TieredBrokerSelector),
the per-query lifecycle (auth, request log, metrics), security, the
data-node scheduler, and query admission, cancellation and deadlines.
Subscriptions (A15) and the coordination endpoints, also the router's
control-plane proxy (A18), wait for later slices (ROADMAP)."""
from druid_tpu_torch.server.avatica import AvaticaServer
from druid_tpu_torch.server.deadline import Deadline, context_timeout_ms
from druid_tpu_torch.server.http import QueryHttpServer
from druid_tpu_torch.server.lifecycle import (QueryLifecycle, RequestLogger,
                                              Unauthorized)
from druid_tpu_torch.server.querymanager import (QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryManager, QueryScheduler,
                                                 QueryTimeoutError, QueryToken)
from druid_tpu_torch.server.router import (Router, RouterHttpServer,
                                            TieredBrokerSelector)
from druid_tpu_torch.server.scheduler import (DataNodeScheduler,
                                              SchedulerConfig,
                                              SchedulerMetricsMonitor)
from druid_tpu_torch.server.security import (AllowAllAuthenticator,
                                             AllowAllAuthorizer, AuthChain,
                                             AuthenticationResult,
                                             BasicHTTPAuthenticator,
                                             Escalator, Permission,
                                             RoleBasedAuthorizer,
                                             authorizer_for_query)

__all__ = ["Deadline", "context_timeout_ms", "QueryManager",
           "QueryScheduler", "QueryToken", "QueryInterruptedError",
           "QueryTimeoutError", "QueryCapacityError", "QueryHttpServer",
           "QueryLifecycle", "RequestLogger", "Unauthorized",
           "DataNodeScheduler", "SchedulerConfig", "SchedulerMetricsMonitor",
           "AuthChain", "AuthenticationResult", "AllowAllAuthenticator",
           "BasicHTTPAuthenticator", "AllowAllAuthorizer",
           "RoleBasedAuthorizer", "Permission", "Escalator",
           "authorizer_for_query", "AvaticaServer", "Router",
           "RouterHttpServer", "TieredBrokerSelector"]
