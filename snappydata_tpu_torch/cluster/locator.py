"""Locator: membership, discovery, failure detection, lead election (port
of snappydata_tpu/cluster/locator.py: the same JSON-line wire format,
names and protocol generation, so a member of either package registers
with a locator of the other).

Re-provides the store engine's P2P membership surface the reference relies
on (SURVEY.md §2.5: locators + view management + `MembershipListener.
memberDeparted` that ExecutorInitiator.scala:71-90 uses to re-point
executors; `member-timeout` 5s default; the `__PRIMARY_LEADER_LS`
distributed lock LeadImpl.scala:100) — as a small TCP JSON-line service:

- members REGISTER (role, host, port) and HEARTBEAT; missing heartbeats
  past `member_timeout_s` → member departed, view version bumps, waiters
  notified on next poll.
- LOCK/UNLOCK implements lease-based named locks; the primary-lead lock is
  just the name "__PRIMARY_LEADER_LS" (standby leads block on it, exactly
  the reference's election).

The locator and its clients touch no device: their threads (the TCP
handlers, the sweeper, the heartbeat loop) make no torch call.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from snappydata_tpu_torch import config
from snappydata_tpu_torch.reliability import failpoints
from snappydata_tpu_torch.utils import locks

_log = logging.getLogger("snappydata_tpu_torch.cluster.locator")

PRIMARY_LEAD_LOCK = "__PRIMARY_LEADER_LS"

# bumped whenever the member-to-member wire contract changes (Flight
# request bodies, repartition/promote actions, WAL record format); the
# locator refuses registration from a member on a different generation
# (ref: SnappyDataVersion handshake)
PROTOCOL_VERSION = 2


@dataclasses.dataclass
class MemberInfo:
    member_id: str
    role: str          # locator | lead | server
    host: str
    port: int          # member's flight port (0 = none)
    last_heartbeat: float = 0.0


class _State:
    def __init__(self, timeout_s: float):
        self.lock = locks.named_lock("locator.state")
        self.members: Dict[str, MemberInfo] = {}
        self.view_version = 0
        self.locks: Dict[str, Tuple[str, float]] = {}  # name -> (owner, expiry)
        self.timeout_s = timeout_s
        self.departed_log: List[str] = []

    def sweep(self) -> None:
        now = time.time()
        with self.lock:
            dead = [m for m, info in self.members.items()
                    if info.role != "locator"
                    and now - info.last_heartbeat > self.timeout_s]
            for m in dead:
                del self.members[m]
                self.departed_log.append(m)
                self.view_version += 1
            # expire locks owned by departed members or past lease
            for name in list(self.locks):
                owner, expiry = self.locks[name]
                if owner not in self.members or now > expiry:
                    del self.locks[name]


class Locator:
    """The discovery/membership service (one per cluster; standby locators
    are a later round)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 member_timeout_s: Optional[float] = None):
        timeout = member_timeout_s or \
            config.global_properties().member_timeout_s
        self.state = _State(timeout)
        state = self.state

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        req = json.loads(line.decode("utf-8"))
                    except ValueError:
                        break
                    resp = _dispatch(state, req)
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode("utf-8"))
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server((host, port), Handler)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> "Locator":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

        def sweep_loop():
            while not self._stop.wait(self.state.timeout_s / 4):
                self.state.sweep()

        self._sweeper = threading.Thread(target=sweep_loop, daemon=True)
        self._sweeper.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.server.shutdown()
        self.server.server_close()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"


def _dispatch(state: _State, req: dict) -> dict:
    op = req.get("op")
    now = time.time()
    if op == "register":
        # version handshake (ref: SnappyDataVersion feature gating,
        # cluster/.../gemxd/SnappyDataVersion.scala): a member speaking a
        # different PROTOCOL generation is refused with a clear message
        # instead of failing later with undecodable exchanges
        peer = req.get("protocol", 0)
        if peer != PROTOCOL_VERSION:
            return {"ok": False,
                    "error": f"protocol version mismatch: member speaks "
                             f"{peer}, cluster speaks {PROTOCOL_VERSION}; "
                             f"upgrade/downgrade the member"}
        with state.lock:
            info = MemberInfo(req["member_id"], req["role"], req["host"],
                              req.get("port", 0), now)
            state.members[req["member_id"]] = info
            state.view_version += 1
            return {"ok": True, "view": state.view_version,
                    "protocol": PROTOCOL_VERSION}
    if op == "heartbeat":
        with state.lock:
            m = state.members.get(req["member_id"])
            if m is None:
                return {"ok": False, "rejoin": True}
            m.last_heartbeat = now
            return {"ok": True, "view": state.view_version}
    if op == "members":
        with state.lock:
            return {"ok": True, "view": state.view_version,
                    "members": [dataclasses.asdict(m)
                                for m in state.members.values()],
                    "departed": list(state.departed_log)}
    if op == "lock":
        name = req["name"]
        lease = float(req.get("lease_s", 30.0))
        with state.lock:
            cur = state.locks.get(name)
            if cur is not None and cur[0] != req["member_id"] \
                    and cur[1] > now and cur[0] in state.members:
                return {"ok": True, "acquired": False, "owner": cur[0]}
            state.locks[name] = (req["member_id"], now + lease)
            return {"ok": True, "acquired": True}
    if op == "unlock":
        with state.lock:
            cur = state.locks.get(req["name"])
            if cur is not None and cur[0] == req["member_id"]:
                del state.locks[req["name"]]
            return {"ok": True}
    if op == "deregister":
        with state.lock:
            state.members.pop(req["member_id"], None)
            state.view_version += 1
            return {"ok": True}
    return {"ok": False, "error": f"unknown op {op}"}


# members whose heartbeat loop GAVE UP (persistent protocol mismatch
# after retries): exposed as the `heartbeats_stopped` gauge so an
# operator can alarm on it — a silently-stopped heartbeat is how a
# healthy member gets swept out of the view
_HB_STOPPED: set = set()
_HB_GAUGE_REGISTERED = False


def _register_hb_gauge() -> None:
    global _HB_GAUGE_REGISTERED
    if not _HB_GAUGE_REGISTERED:
        from snappydata_tpu_torch.observability.metrics import global_registry

        global_registry().gauge("heartbeats_stopped",
                                lambda: float(len(_HB_STOPPED)))
        _HB_GAUGE_REGISTERED = True


class LocatorClient:
    """A member's handle to the locator (persistent connection +
    heartbeat thread)."""

    # consecutive protocol-shaped (RuntimeError) heartbeat failures
    # tolerated with capped-backoff retries before the loop gives up —
    # a locator restart mid-upgrade answers the handshake wrong for a
    # few beats; a REAL version mismatch persists past the cap and
    # still stops loudly (gauge + error log)
    HEARTBEAT_GIVEUP = 5
    HEARTBEAT_BACKOFF_MAX_S = 30.0

    def __init__(self, address: str, member_id: str, role: str,
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 5.0):
        self.address = address
        self.member_id = member_id
        self.role = role
        self.host = host
        self.port = port
        # connect AND read timeout: a wedged locator socket must not
        # park the heartbeat thread inside _lock forever (every other
        # locator call would then block on the lock behind it)
        self.request_timeout_s = request_timeout_s
        self._lock = locks.named_lock("locator.client")
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._hb: Optional[threading.Thread] = None
        self.last_view = -1

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, payload: dict) -> dict:
        with self._lock:
            if self._sock is None:
                h, p = self.address.rsplit(":", 1)
                self._sock = socket.create_connection(
                    (h, int(p)), timeout=self.request_timeout_s)
                # create_connection's timeout persists as the socket
                # timeout, but make the read deadline explicit — it is
                # the contract, not a connect-time leftover
                self._sock.settimeout(self.request_timeout_s)
                self._fh = self._sock.makefile("rwb")
            try:
                self._fh.write((json.dumps(payload) + "\n").encode("utf-8"))
                self._fh.flush()
                line = self._fh.readline()
            except (socket.timeout, OSError) as e:
                # timed-out/broken socket: its stream buffer is desynced,
                # drop it so the next request reconnects cleanly
                self._close_locked()
                raise ConnectionError(f"locator request failed: {e}")
            if not line:
                self._close_locked()
                raise ConnectionError("locator connection lost")
            try:
                return json.loads(line.decode("utf-8"))
            except ValueError:
                # partial/garbled response (locator died mid-write): the
                # stream is desynced — surface it as the connection loss
                # it is, so the heartbeat loop's re-register path (not a
                # silent thread death) handles it
                self._close_locked()
                raise ConnectionError("locator sent a garbled response")

    def register(self) -> dict:
        resp = self._request({"op": "register", "member_id": self.member_id,
                              "role": self.role, "host": self.host,
                              "port": self.port,
                              "protocol": PROTOCOL_VERSION})
        if not resp.get("ok", True) and "protocol" in str(
                resp.get("error", "")):
            raise RuntimeError(resp["error"])
        self.last_view = resp.get("view", -1)
        return resp

    def start_heartbeats(self, interval_s: float = 1.0) -> None:
        """Background heartbeat loop. Failures route through `logging`
        and the `member_heartbeat_failures` counter (a heartbeat thread
        that dies printing to stderr is how a member gets silently swept
        out — the metric is what an operator alarms on); transient
        connection errors re-register and keep beating.

        Protocol-shaped failures (RuntimeError — e.g. a locator restart
        mid-upgrade answering the version handshake wrong for a beat or
        two) used to STOP the loop on the first hit and the member got
        swept out of the view; now they retry with capped exponential
        backoff and only HEARTBEAT_GIVEUP consecutive failures stop the
        loop — visibly, on the `heartbeats_stopped` gauge."""
        from snappydata_tpu_torch.observability.metrics import global_registry

        _register_hb_gauge()

        def giveup(e) -> bool:
            _log.error("member %s: %s; stopping heartbeats after %d "
                       "protocol retries", self.member_id, e,
                       self.HEARTBEAT_GIVEUP)
            _HB_STOPPED.add(self.member_id)
            global_registry().inc("member_heartbeats_stopped")
            return True

        def backoff_wait(fails: int) -> bool:
            """Capped-backoff sleep; True when the client was closed."""
            delay = min(interval_s * (2 ** max(0, fails - 1)),
                        self.HEARTBEAT_BACKOFF_MAX_S)
            _log.warning("member %s: transient heartbeat protocol "
                         "failure %d/%d; retrying in %.2fs",
                         self.member_id, fails, self.HEARTBEAT_GIVEUP,
                         delay)
            return self._stop.wait(delay)

        def loop():
            proto_fails = 0
            while not self._stop.wait(interval_s):
                try:
                    failpoints.hit("locator.heartbeat")
                    resp = self._request({"op": "heartbeat",
                                          "member_id": self.member_id})
                    if resp.get("rejoin"):
                        self.register()
                    self.last_view = resp.get("view", self.last_view)
                    proto_fails = 0
                    _HB_STOPPED.discard(self.member_id)
                except RuntimeError as e:
                    global_registry().inc("member_heartbeat_failures")
                    proto_fails += 1
                    if proto_fails >= self.HEARTBEAT_GIVEUP and giveup(e):
                        return
                    if backoff_wait(proto_fails):
                        return
                except (ConnectionError, OSError) as e:
                    global_registry().inc("member_heartbeat_failures")
                    _log.warning("member %s: heartbeat failed (%s); "
                                 "re-registering", self.member_id, e)
                    try:
                        self.register()
                        proto_fails = 0
                    except RuntimeError as e2:
                        proto_fails += 1
                        if proto_fails >= self.HEARTBEAT_GIVEUP \
                                and giveup(e2):
                            return
                        if backoff_wait(proto_fails):
                            return
                    except (ConnectionError, OSError):
                        pass   # locator still down: retry next tick

        self._hb = threading.Thread(target=loop, daemon=True)
        self._hb.start()

    def members(self) -> List[MemberInfo]:
        resp = self._request({"op": "members"})
        return [MemberInfo(**m) for m in resp["members"]]

    def try_lock(self, name: str, lease_s: float = 30.0) -> bool:
        resp = self._request({"op": "lock", "name": name,
                              "member_id": self.member_id,
                              "lease_s": lease_s})
        return bool(resp.get("acquired"))

    def unlock(self, name: str) -> None:
        self._request({"op": "unlock", "name": name,
                       "member_id": self.member_id})

    def close(self) -> None:
        self._stop.set()
        _HB_STOPPED.discard(self.member_id)  # deliberate shutdown ≠ alarm
        try:
            self._request({"op": "deregister", "member_id": self.member_id})
        except (ConnectionError, OSError):
            pass
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
