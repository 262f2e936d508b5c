"""Node roles + lifecycle (port of snappydata_tpu/cluster/node.py; the
ServiceManager / LeadImpl / ServerImpl analogue, cluster/.../
ServiceManager.scala, impl/LeadImpl.scala:94, core/.../impl/
ServerImpl.scala:34).

- LocatorNode: runs the membership/locator service.
- ServerNode:  data host — Flight front door over a session (the embedded
  network-server-in-the-data-JVM design), registers + heartbeats.
- LeadNode:    acquires the primary-lead lock (standby blocks and takes
  over on primary death — LeadImpl.scala:100 election), then runs the
  stats service + REST/jobs + its own Flight endpoint.

Single-host: nodes share the process's catalog/storage (embedded mode).
A lead that becomes primary builds its cluster view, a
`DistributedSession` over the data servers the locator lists, on its
session's device; the view answers `/rebalance` and
`/redundancy/restore`.  A server's submesh (`mesh_devices`, slots of
parallel/mesh.py) becomes its session's `default_mesh`, so every query it
serves runs over those slots.  The lead's election
thread enters its session's `config.device_scope`, since becoming
primary starts the stats service and the cluster view on it.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from snappydata_tpu_torch import config
from snappydata_tpu_torch.cluster.locator import (Locator, LocatorClient,
                                                  PRIMARY_LEAD_LOCK)


class LocatorNode:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.locator = Locator(host, port)

    def start(self) -> "LocatorNode":
        self.locator.start()
        return self

    def stop(self) -> None:
        self.locator.stop()

    @property
    def address(self) -> str:
        return self.locator.address


class _MemberNode:
    role = "member"

    def __init__(self, locator_address: str, session,
                 host: str = "127.0.0.1", flight_port: int = 0,
                 member_id: Optional[str] = None):
        self.session = session
        self.member_id = member_id or f"{self.role}-{uuid.uuid4().hex[:8]}"
        self.host = host
        self.locator_address = locator_address
        self._flight_port = flight_port
        self.flight = None
        self.membership: Optional[LocatorClient] = None

    @property
    def flight_address(self) -> str:
        """Every member answers queries over Flight (the lead IS an
        engine too) — failover clients pin to a tier via this."""
        return f"{self.host}:{self.flight.port}"

    def _start_flight(self) -> int:
        from snappydata_tpu_torch.cluster.flight_server import \
            SnappyFlightServer
        from snappydata_tpu_torch.security import make_provider

        tokens = self.session.conf.get("auth_tokens") or None
        provider = make_provider(self.session.conf)
        cluster_token = self.session.conf.get("auth_cluster_token")
        if provider is not None and not cluster_token:
            # login tokens are per-server: without a cluster-shared secret,
            # server→server traffic (repartition/replicate do_put) would be
            # rejected by peers mid-operation — fail at boot, not mid-shuffle
            raise ValueError(
                "auth_provider is configured but auth_cluster_token is not: "
                "cluster members need a shared secret to authenticate "
                "server-to-server traffic (set auth_cluster_token to the "
                "same value on every member)")
        self.flight = SnappyFlightServer(self.session, self.host,
                                         self._flight_port,
                                         auth_tokens=tokens,
                                         auth_provider=provider,
                                         internal_token=cluster_token)
        self._flight_thread = threading.Thread(target=self.flight.serve,
                                               daemon=True)
        self._flight_thread.start()
        # the port is bound at construction; wait for the serve loop to
        # actually accept connections before registering with the locator
        self.flight.wait_ready(timeout=10)
        return self.flight.port

    def _join(self, port: int) -> None:
        self.membership = LocatorClient(self.locator_address,
                                        self.member_id, self.role,
                                        self.host, port)
        self.membership.register()
        self.membership.start_heartbeats()

    def stop(self) -> None:
        if self.membership is not None:
            self.membership.close()
        if self.flight is not None:
            self.flight.shutdown()


class ServerNode(_MemberNode):
    """Data server: storage + Flight query/ingest endpoint.

    `mesh_devices`: indices of the LOCAL shard slots this server owns
    (parallel/mesh.py `slots()`); the server's session runs every query
    over that submesh, composing the cluster plane (scatter over servers)
    with the mesh plane (per-slot partials inside each server).  Ref: one
    long-lived embedded executor per store JVM."""

    role = "server"

    def __init__(self, locator_address: str, session,
                 host: str = "127.0.0.1", flight_port: int = 0,
                 member_id: Optional[str] = None,
                 mesh_devices: Optional[list] = None):
        super().__init__(locator_address, session, host, flight_port,
                         member_id)
        self.mesh_devices = list(mesh_devices) if mesh_devices else None
        if mesh_devices:
            from snappydata_tpu_torch.parallel.mesh import submesh

            session.default_mesh = submesh(mesh_devices, session.device)

    def start(self) -> "ServerNode":
        port = self._start_flight()
        self._join(port)
        return self


class LeadNode(_MemberNode):
    """Lead: primary/standby election, then planner-side services."""

    role = "lead"

    def __init__(self, locator_address: str, session,
                 host: str = "127.0.0.1", flight_port: int = 0,
                 rest_port: int = 0, lease_s: float = 5.0,
                 member_id: Optional[str] = None):
        super().__init__(locator_address, session, host, flight_port,
                         member_id)
        self.rest_port = rest_port
        self.lease_s = lease_s
        self.is_primary = False
        self.rest = None
        self.stats_service = None
        self._stop_event = threading.Event()
        self._election: Optional[threading.Thread] = None

    def start(self, wait_for_primary: bool = False) -> "LeadNode":
        port = self._start_flight()
        self._join(port)
        self._election = threading.Thread(target=self._election_loop,
                                          daemon=True)
        self._election.start()
        if wait_for_primary:
            deadline = time.time() + 30
            while not self.is_primary and time.time() < deadline:
                time.sleep(0.05)
        return self

    def _election_loop(self) -> None:
        """Standby blocks on the primary lock; the holder renews its lease
        (half-life cadence). Exactly the reference's dlock election."""
        with config.device_scope(self.session.device):
            while not self._stop_event.is_set():
                try:
                    acquired = self.membership.try_lock(
                        PRIMARY_LEAD_LOCK, lease_s=self.lease_s)
                except (ConnectionError, OSError):
                    acquired = False
                if acquired and not self.is_primary:
                    self._become_primary()
                elif not acquired and self.is_primary:
                    self._step_down()
                self._stop_event.wait(self.lease_s / 2)

    def _become_primary(self) -> None:
        from snappydata_tpu_torch.cluster.rest import RestService
        from snappydata_tpu_torch.observability import TableStatsService
        from snappydata_tpu_torch.security import make_provider

        self.stats_service = TableStatsService(self.session.catalog).start()
        self.rest = RestService(self.session, self.stats_service,
                                membership=self.membership,
                                host=self.host, port=self.rest_port,
                                auth_tokens=self.session.conf.get(
                                    "auth_tokens") or None,
                                auth_provider=make_provider(
                                    self.session.conf)).start()
        # cluster view for operator actions (POST /rebalance): a
        # DistributedSession over the data servers the locator knows, on
        # the lead session's device.  Only "no servers yet" passes here
        # (the locator does not answer, or lists no server): a device
        # error or a fault of the view itself propagates
        from snappydata_tpu_torch.cluster.distributed import (
            DistributedError, DistributedSession)

        try:
            servers = sorted(f"{m.host}:{m.port}"
                             for m in self.membership.members()
                             if m.role == "server")
            if servers:
                self.rest.distributed = DistributedSession(
                    server_addresses=servers, device=self.session.device)
        except (ConnectionError, OSError, DistributedError):
            pass  # no servers yet: /rebalance reports 409 until retried
        self.is_primary = True

    def _step_down(self) -> None:
        self.is_primary = False
        if self.rest is not None:
            self.rest.stop()
            self.rest = None
        if self.stats_service is not None:
            self.stats_service.stop()
            self.stats_service = None

    def stop(self) -> None:
        self._stop_event.set()
        if self._election is not None:
            # a promotion in flight finishes before the step-down below,
            # so no REST service outlives the node
            self._election.join(timeout=30)
        if self.is_primary:
            try:
                self.membership.unlock(PRIMARY_LEAD_LOCK)
            except (ConnectionError, OSError):
                pass
            self._step_down()
        super().stop()

    @property
    def rest_address(self) -> Optional[str]:
        if self.rest is None:
            return None
        return f"{self.rest.host}:{self.rest.port}"
