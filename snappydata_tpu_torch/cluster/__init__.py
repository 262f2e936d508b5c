"""Cluster runtime (port of snappydata_tpu/cluster): locator / lead /
server roles and their front doors.

Reference topology (docs/architecture/cluster_architecture.md:3-9):
locators do discovery + membership, the lead hosts the (HA) query planner
and job/REST services, data servers host buckets and answer simple queries
directly. Here the same roles over a TCP membership protocol
(locator.py, node.py), an Arrow Flight and Flight SQL data/query front
door per node (flight_server.py, flightsql.py — the thrift/DRDA
network-server analogue, cluster/README-thrift.md), a REST
status/metrics/jobs surface on the lead (rest.py — the jobserver +
/status/api/v1 analogue) and the failover-aware client with its retry
layer (client.py, retry.py).  The distributed session over the data
servers (scatter-gather, bucket placement, the lead's `/rebalance`) is
not ported yet.
"""

from snappydata_tpu_torch.cluster.locator import (  # noqa: F401
    Locator, MemberInfo,
)
from snappydata_tpu_torch.cluster.node import (  # noqa: F401
    LocatorNode, LeadNode, ServerNode,
)
from snappydata_tpu_torch.cluster.client import SnappyClient  # noqa: F401
