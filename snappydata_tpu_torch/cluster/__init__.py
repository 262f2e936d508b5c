"""Front doors of one server (port of snappydata_tpu/cluster): the Arrow
Flight and Flight SQL server (flight_server.py, flightsql.py), the REST
status / metrics / jobs surface (rest.py) and the direct-address client
with its retry layer (client.py, retry.py).

Reference topology (docs/architecture/cluster_architecture.md:3-9):
locators do discovery + membership, the lead hosts the (HA) query planner
and job/REST services, data servers host buckets and answer simple queries
directly.  The membership half (the locator, the server / lead nodes,
the distributed session) is not ported yet, so this package exports the
client only.
"""

from snappydata_tpu_torch.cluster.client import SnappyClient  # noqa: F401
