"""Resource governor: unified memory accounting, admission control and
cooperative query cancellation (port of snappydata_tpu/resource; ref:
SnappyUnifiedMemoryManager, critical-heap-percentage fail-fast and the
CancelException checks in generated scan loops).

Public surface:
- `global_broker()`: the process-wide `ResourceBroker` (ledger,
  admission, degradation, cancellation);
- `QueryContext` / `new_query()` / `query_scope()` / `current_query()` /
  `check_current()`: the per-query context threaded through session ->
  executor -> host eval, checked at plan, batch and tile boundaries;
- `LowMemoryException` (SQLSTATE XCL54) and `CancelException`
  (SQLSTATE XCL52);
- `estimate_query_bytes()`: the rows x decoded width admission estimate.
"""

from snappydata_tpu_torch.resource.broker import (ResourceBroker,
                                                  global_broker)
from snappydata_tpu_torch.resource.context import (CancelException,
                                                   LowMemoryException,
                                                   QueryContext,
                                                   check_current,
                                                   current_query, new_query,
                                                   query_scope)
from snappydata_tpu_torch.resource.estimate import (estimate_query_bytes,
                                                    estimate_statement_bytes)

__all__ = [
    "ResourceBroker", "global_broker",
    "QueryContext", "new_query", "query_scope", "current_query",
    "check_current",
    "LowMemoryException", "CancelException",
    "estimate_query_bytes", "estimate_statement_bytes",
]
