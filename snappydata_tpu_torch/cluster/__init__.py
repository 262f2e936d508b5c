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
layer (client.py, retry.py).  `distributed.DistributedSession` is the
lead's scatter-gather session over the data servers (bucket placement,
exchanges, redundancy and failover, hedged reads, plan shipping); as in
the reference it is imported from its module, not from here.
"""

from snappydata_tpu_torch.cluster.locator import (  # noqa: F401
    Locator, MemberInfo,
)
from snappydata_tpu_torch.cluster.node import (  # noqa: F401
    LocatorNode, LeadNode, ServerNode,
)
from snappydata_tpu_torch.cluster.client import SnappyClient  # noqa: F401
