"""REST surface: status API, metrics, job submission (port of
snappydata_tpu/cluster/rest.py; the routes and JSON bodies are the
reference's).  On a lead the service holds the locator's `membership`,
whose members the cluster route and the dashboard list, and the lead's
cluster view `distributed` (a `DistributedSession` over the data
servers), which answers the operator routes `/rebalance`,
`/redundancy/restore` and `/wal/flush` and fills the HA route's member
and redundancy lines.  Request handlers
run on `ThreadingHTTPServer`'s threads and jobs on threads of their own,
so each enters the session's `config.device_scope` itself.

Reference: `/status/api/v1` JSON resources (cluster/.../status/api/v1/
snappyapi.scala), MetricsServlet at lead:5050/metrics/json
(docs/monitoring/metrics.md:8), and the spark-jobserver REST contract
(SnappySQLJob.runSnappyJob, cluster/.../SnappySessionFactory.scala:112-136).
"""

from __future__ import annotations

import json
import threading
from snappydata_tpu_torch.utils import locks
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry


class JobRegistry:
    """Async SQL jobs (the jobserver analogue): submit → job id → poll."""

    def __init__(self, session):
        self.session = session
        self._jobs: Dict[str, dict] = {}
        self._lock = locks.named_lock("rest.jobs")

    def submit_sql(self, sql: str, params=(), session=None,
                   timeout_s=None) -> str:
        from snappydata_tpu_torch import resource

        job_id = uuid.uuid4().hex[:12]
        sess = session or self.session
        # the job's governor context is created AND registered up front
        # so its queryId is visible (GET /jobs/<id>) and cancellable
        # (POST /queries/<qid>/cancel) from the moment of submission —
        # even before the worker thread reaches admission
        ctx = resource.global_broker().watch(
            resource.new_query(sql, user=sess.user))
        if timeout_s:
            # per-request deadline counts from SUBMISSION (queue time
            # included, like query_timeout_s)
            ctx.set_deadline_in(float(timeout_s))
        with self._lock:
            self._jobs[job_id] = {"status": "RUNNING", "sql": sql,
                                  "queryId": ctx.query_id}

        def run():
            from snappydata_tpu_torch.observability import tracing

            try:
                with config.device_scope(sess.device), \
                        tracing.request_scope(sql, user=sess.user,
                                           kind="job") as tr:
                    if tr is not None:
                        with self._lock:
                            self._jobs[job_id]["trace_id"] = tr.trace_id
                    result = sess.sql(sql, params=params, query_ctx=ctx)
                with self._lock:
                    self._jobs[job_id].update(
                        status="FINISHED",
                        rows=[[_j(v) for v in r] for r in
                              result.rows()[:1000]],
                        names=result.names)
            except Exception as e:
                with self._lock:
                    self._jobs[job_id].update(status="ERROR", error=str(e))
            finally:
                # idempotent: clears the watched registration even when
                # the statement failed before reaching admission (parse
                # errors included)
                resource.global_broker().release(ctx)

        threading.Thread(target=run, daemon=True).start()
        return job_id

    def status(self, job_id: str) -> Optional[dict]:
        with self._lock:
            return dict(self._jobs.get(job_id) or {}) or None

    def list(self) -> dict:
        with self._lock:
            return {jid: j["status"] for jid, j in self._jobs.items()}


def _fault_list() -> list:
    """The armed failpoints in the reference's JSON shape (its
    `FaultSpec.to_dict`): the port keeps one registry, whose specs name
    the probability `prob` and leave an unset exception family None."""
    from snappydata_tpu_torch.reliability import failpoints

    out = []
    for d in failpoints.snapshot():
        row = {"name": d["name"], "action": d["action"],
               "param": d["param"], "exc": d.get("exc") or "io",
               "phase": d["phase"], "count": d.get("count"),
               "every": d.get("every"), "p": d.get("prob"),
               "hits": d["hits"], "fired": d["fired"]}
        out.append({k: v for k, v in row.items() if v is not None})
    return out


def _j(v):
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    return str(v)


def _members(svc) -> list:
    """The locator's view of the cluster, or [] on a service without
    membership or while the locator does not answer."""
    if svc.membership is None:
        return []
    try:
        return svc.membership.members()
    except (ConnectionError, OSError):
        return []


def _render_dashboard(svc) -> str:
    """Minimal HTML dashboard (ref: SnappyDashboardPage cluster overview +
    member grid + table stats)."""
    from html import escape as esc

    members = _members(svc)
    tables = svc.stats_service.current()
    snap = global_registry().snapshot()
    rows_m = "".join(
        f"<tr><td>{esc(str(m.role))}</td><td>{esc(str(m.member_id))}</td>"
        f"<td>{esc(str(m.host))}:{m.port}</td></tr>" for m in members)
    rows_t = "".join(
        f"<tr><td>{esc(str(name))}</td><td>{esc(str(t['provider']))}</td>"
        f"<td>{t['row_count']:,}</td><td>{t['batches']}</td>"
        f"<td>{t['in_memory_bytes']:,}</td></tr>"
        for name, t in sorted(tables.items()))
    counters = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{v}</td></tr>"
        for k, v in sorted(snap["counters"].items()))
    from snappydata_tpu_torch.observability.stats_service import (
        durability_snapshot, ha_snapshot, join_snapshot, scan_snapshot)

    ha = ha_snapshot(svc.session.catalog, svc.distributed)
    rows_ha = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in ha.items())
    wal = durability_snapshot()
    rows_w = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in wal.items() if not isinstance(v, dict)) + (
        f"<tr><td>wal_group_flush_ms (mean/max)</td>"
        f"<td>{wal['wal_group_flush_ms']['mean_ms']} / "
        f"{wal['wal_group_flush_ms']['max_ms']}</td></tr>")
    agg = scan_snapshot(svc.session.catalog)
    enc_tables = agg.pop("tables", {})
    rows_agg = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in agg.items())
    rows_enc = "".join(
        f"<tr><td>{esc(str(name))}</td><td>{t['rows']:,}</td>"
        f"<td>{esc(str(t['encoding_mix']))}</td>"
        f"<td>{t['at_rest_bytes']:,}</td><td>{t['decoded_bytes']:,}</td>"
        f"<td>{esc(str(t['at_rest_ratio']))}</td>"
        f"<td>{t['device_resident_bytes']:,}</td>"
        f"<td>{esc(str(t['resident_bytes_per_row']))}</td></tr>"
        for name, t in sorted(enc_tables.items()))
    jn = join_snapshot()
    rows_jn = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in jn.items())
    from snappydata_tpu_torch.observability.stats_service import mesh_snapshot

    msh = mesh_snapshot(svc.session.catalog, svc.session)
    mesh_placement = msh.pop("placement", None)
    mesh_perdev = msh.pop("resident_bytes_by_device", {})
    rows_msh = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in msh.items())
    if mesh_placement is not None:
        rows_msh += (
            f"<tr><td>placement (gen "
            f"{mesh_placement['generation']}, "
            f"{mesh_placement['num_buckets']} buckets)</td>"
            f"<td>{esc(str(mesh_placement['bucket_map']))}</td></tr>")
    rows_mshd = "".join(
        f"<tr><td>{esc(str(d))}</td><td>{b:,}</td></tr>"
        for d, b in mesh_perdev.items())
    from snappydata_tpu_torch.views import view_snapshot

    mv = view_snapshot(svc.session.catalog)
    rows_mv = "".join(
        f"<tr><td>{esc(str(v['name']))}</td>"
        f"<td>{esc(str(v['base_table']))}</td><td>{v['groups']:,}</td>"
        f"<td>{v['state_bytes']:,}</td>"
        f"<td>{'STALE' if v['stale'] else 'fresh'}</td>"
        f"<td>{v['delta_folds']}</td><td>{v['rows_folded']:,}</td>"
        f"<td>{v['full_refreshes']}</td></tr>"
        for v in mv["views"])
    rows_mvc = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in mv.items() if k != "views")
    from snappydata_tpu_torch.observability.stats_service import storage_snapshot

    stg = storage_snapshot()
    rows_stg = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in stg["tier"].items()) + "".join(
        f"<tr><td>prefetch {esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in stg["prefetch"].items()) + (
        f"<tr><td>failpoint fires</td>"
        f"<td>{stg['failpoints']['fires']} "
        f"({len(stg['failpoints']['armed'])} armed)</td></tr>")
    from snappydata_tpu_torch.observability.stats_service import mvcc_snapshot

    mvc = mvcc_snapshot(svc.session.catalog)
    mvcc_tables = mvc.pop("tables", {})
    rows_mvcc = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in mvc.items())
    rows_mvcct = "".join(
        f"<tr><td>{esc(str(name))}</td><td>{t['version']}</td>"
        f"<td>{t['epoch']}</td><td>{t['wal_seq']}</td>"
        f"<td>{len(t['retained_epochs'])}</td>"
        f"<td>{sum(e['pins'] for e in t['retained_epochs'])}</td>"
        f"<td>{t['retained_bytes']:,}</td></tr>"
        for name, t in sorted(mvcc_tables.items()))
    from snappydata_tpu_torch.serving import serving_snapshot

    sv = serving_snapshot(svc.session.catalog)
    rows_sv = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in sv.items() if k != "handles")
    rows_svh = "".join(
        f"<tr><td>{esc(str(h['sql']))}</td><td>{h['params']}</td>"
        f"<td>{h['executes']}</td>"
        f"<td>{esc(str(h['passthrough'] or 'compiled'))}</td></tr>"
        for h in sv.get("handles", ()))
    recent = list(reversed(svc.session.recent_queries()))[:25]
    rows_q = "".join(
        f"<tr><td>{esc(str(q['sql']))[:120]}</td><td>{q['ms']}</td>"
        f"<td>{q['rows']}</td><td>{esc(str(q.get('user', '')))}</td></tr>"
        for q in recent)
    from snappydata_tpu_torch.observability.tracing import (ring,
                                                      tracing_snapshot)

    trc = tracing_snapshot()
    rows_trc = "".join(
        f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td></tr>"
        for k, v in trc.items())
    rows_trq = "".join(
        f"<tr><td><code>{esc(str(t['trace_id']))}</code></td>"
        f"<td>{esc(str(t['kind']))}</td>"
        f"<td>{esc(str(t['sql']))[:100]}</td><td>{t['ms']}</td>"
        f"<td>{t['spans']}</td><td>{esc(str(t['status']))}</td></tr>"
        for t in ring().traces(15))
    streams = svc.session.streaming_queries()
    rows_s = "".join(
        f"<tr><td>{esc(str(q['name']))}</td><td>{esc(str(q['table']))}</td>"
        f"<td>{'yes' if q['active'] else 'NO'}</td>"
        f"<td>{q['batches_processed']}</td><td>{q['rows_processed']:,}</td>"
        f"<td>{q['rows_per_s']:,}</td>"
        f"<td>{esc(str(q['last_error'] or ''))[:80]}</td></tr>"
        for q in streams)
    return f"""<!doctype html><html><head><title>snappydata_tpu_torch</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:
collapse;margin:1em 0}}td,th{{border:1px solid #ccc;padding:4px 10px;
text-align:left}}h2{{margin-top:1.5em}}</style></head><body>
<h1>snappydata_tpu_torch</h1>
<h2>Members ({len(members)})</h2>
<table><tr><th>role</th><th>member</th><th>address</th></tr>{rows_m}</table>
<h2>Tables ({len(tables)})</h2>
<table><tr><th>table</th><th>provider</th><th>rows</th><th>batches</th>
<th>bytes</th></tr>{rows_t}</table>
<h2>Streaming queries ({len(streams)})</h2>
<table><tr><th>query</th><th>table</th><th>active</th><th>batches</th>
<th>rows</th><th>rows/s</th><th>last error</th></tr>{rows_s}</table>
<h2>High availability (deadlines / hedges / dedup / rejoin)</h2>
<table>{rows_ha}</table>
<h2>Durability (WAL group commit)</h2><table>{rows_w}</table>
<h2>Scan &amp; decode (compressed domain / Aggregation engine /
tiled scans)</h2>
<table>{rows_agg}</table>
<table><tr><th>table</th><th>rows</th><th>encoding mix</th>
<th>at-rest bytes</th><th>decoded bytes</th><th>at-rest ratio</th>
<th>device resident</th><th>resident B/row</th></tr>{rows_enc}</table>
<h2>Join engine (device path / build cache / expansion)</h2>
<table>{rows_jn}</table>
<h2>Mesh execution (shard_map lane / exchange / placement)</h2>
<table>{rows_msh}</table>
<table><tr><th>device</th><th>resident bytes</th></tr>{rows_mshd}</table>
<h2>Serving path (prepared statements / micro-batched dispatch)</h2>
<table>{rows_sv}</table>
<table><tr><th>prepared sql</th><th>params</th><th>executes</th>
<th>mode</th></tr>{rows_svh}</table>
<h2>Storage (tier ladder / self-healing / prefetch workers)</h2>
<table>{rows_stg}</table>
<h2>Snapshot isolation (MVCC epochs / pins / retained bytes)</h2>
<table>{rows_mvcc}</table>
<table><tr><th>table</th><th>version</th><th>epoch</th><th>commit seq</th>
<th>retained epochs</th><th>pins</th><th>retained bytes</th></tr>
{rows_mvcct}</table>
<h2>Materialized views ({len(mv["views"])})</h2>
<table><tr><th>view</th><th>base</th><th>groups</th><th>state bytes</th>
<th>freshness</th><th>delta folds</th><th>rows folded</th>
<th>full refreshes</th></tr>{rows_mv}</table>
<table>{rows_mvc}</table>
<h2>Tracing (trace ring / slow-query log)</h2>
<table>{rows_trc}</table>
<table><tr><th>trace id</th><th>kind</th><th>sql</th><th>ms</th>
<th>spans</th><th>status</th></tr>{rows_trq}</table>
<p>Detail: GET /status/api/v1/traces?trace_id=&lt;id&gt;</p>
<h2>Counters</h2><table>{counters}</table>
<h2>Recent queries ({len(recent)})</h2>
<table><tr><th>sql</th><th>ms</th><th>rows</th><th>user</th></tr>{rows_q}
</table>
<p>Plans: GET /status/api/v1/queries/plan?id=N</p>
</body></html>"""


class RestService:
    # validated Basic credentials are cached this long, bounding both the
    # per-request provider cost (LDAP bind) and the revocation latency
    BASIC_CACHE_TTL_S = 300.0

    def __init__(self, session, stats_service, membership=None,
                 host: str = "127.0.0.1", port: int = 0,
                 auth_tokens=None, auth_provider=None):
        """`membership`: the lead's `LocatorClient`, whose view the cluster
        route and the dashboard list.
        `auth_tokens`: token → user map. When configured, job submission
        requires `Authorization: Bearer <token>` (or `X-Snappy-Token`) and
        runs as that principal; when absent, jobs run as an unauthenticated
        remote session (EXEC PYTHON refused — advisor finding: the job
        endpoint used to execute arbitrary SQL as the admin superuser).
        `auth_provider` (BUILTIN/LDAP) additionally accepts
        `Authorization: Basic <user:password>` credentials; validated
        principals are cached so LDAP isn't bound per request."""
        self.session = session
        self.stats_service = stats_service
        self.membership = membership
        # optional DistributedSession (the lead's cluster view) — powers
        # operator actions like POST /rebalance
        self.distributed = None
        self.auth_tokens = auth_tokens or {}
        self.auth_provider = auth_provider
        self._basic_cache = {}   # sha256(user:password) -> (user, expiry)
        self.jobs = JobRegistry(session)
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, payload, code=200, content_type="application/json"):
                body = payload if isinstance(payload, bytes) else \
                    json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                with config.device_scope(svc.session.device):
                    self._get()

            def do_POST(self):
                with config.device_scope(svc.session.device):
                    self._post()

            def _get(self):
                path = self.path.split("?")[0].rstrip("/")
                if path == "/status/api/v1/cluster":
                    self._send({"members": [vars(m) for m in
                                            _members(svc)],
                                "tables": svc.stats_service.current()})
                elif path == "/status/api/v1/ha":
                    # end-to-end reliability stats: failovers, hedged
                    # reads, mutation-retry dedup, rejoins, deadline
                    # expiries, heartbeat health — plus live membership
                    # and bucket-redundancy state when this lead holds a
                    # cluster view
                    from snappydata_tpu_torch.observability.stats_service \
                        import ha_snapshot

                    self._send(ha_snapshot(svc.session.catalog,
                                           svc.distributed))
                elif path == "/status/api/v1/tables":
                    self._send(svc.stats_service.current())
                elif path == "/status/api/v1/wal":
                    # group-commit write-path stats: fsync mode/knobs +
                    # wal_fsync_count / wal_group_commit_batches /
                    # wal_bytes_written / flush timings
                    from snappydata_tpu_torch.observability.stats_service import \
                        durability_snapshot

                    self._send(durability_snapshot())
                elif path == "/status/api/v1/scan":
                    # scan read-path stats: reduction strategies,
                    # fused-pass counts, group-index cache hit rate,
                    # tiled-scan device merges, and the compressed-domain
                    # block (code/run predicates, dictionary batch
                    # skipping, per-reason fallbacks, per-table encoding
                    # mix + at-rest vs decoded bytes)
                    from snappydata_tpu_torch.observability.stats_service import \
                        scan_snapshot

                    self._send(scan_snapshot(svc.session.catalog))
                elif path == "/status/api/v1/join":
                    # join-engine stats: device vs host-path counts (host
                    # fallbacks itemized by reason), build-artifact cache
                    # hit rate/bytes, one-to-many expansion factor
                    from snappydata_tpu_torch.observability.stats_service import \
                        join_snapshot

                    self._send(join_snapshot())
                elif path == "/status/api/v1/serving":
                    # prepared-statement serving stats: registry
                    # population + compile-once and batched-dispatch
                    # evidence counters (handle SQL text leaks literals →
                    # same auth as /queries)
                    if self._principal_session() is None:
                        return
                    from snappydata_tpu_torch.serving import serving_snapshot

                    self._send(serving_snapshot(svc.session.catalog))
                elif path == "/status/api/v1/views":
                    # materialized-view stats: per-view state size /
                    # staleness / fold counters + the global fold totals
                    # proving O(delta) maintenance (view definitions leak
                    # SQL text → same auth as /queries)
                    if self._principal_session() is None:
                        return
                    from snappydata_tpu_torch.views import view_snapshot

                    self._send(view_snapshot(svc.session.catalog))
                elif path == "/status/api/v1/storage":
                    # tiered-storage health: per-rung resident bytes,
                    # quarantine/rebuild ledger, prefetch-worker
                    # liveness, armed failpoints — the self-healing
                    # story as numbers
                    from snappydata_tpu_torch.observability.stats_service import \
                        storage_snapshot

                    self._send(storage_snapshot())
                elif path == "/status/api/v1/mvcc":
                    # snapshot-isolation stats: epoch clock, active pins,
                    # per-table version vector + retained-epoch list and
                    # bytes — what readers can rely on, as numbers
                    from snappydata_tpu_torch.observability.stats_service import \
                        mvcc_snapshot

                    self._send(mvcc_snapshot(svc.session.catalog))
                elif path == "/status/api/v1/mesh":
                    # mesh execution: shard_map lane counters, join
                    # distribution strategies, bucket→device placement,
                    # per-device resident plate bytes
                    from snappydata_tpu_torch.observability.stats_service import \
                        mesh_snapshot

                    self._send(mesh_snapshot(svc.session.catalog,
                                             svc.session))
                elif path == "/status/api/v1/streaming":
                    # streaming query progress (ref: the structured-
                    # streaming UI tab / StreamingQueryManager.active);
                    # last_error may embed SQL/data → same auth as /queries
                    if self._principal_session() is None:
                        return
                    self._send(svc.session.streaming_queries())
                elif path == "/status/api/v1/traces":
                    # request-trace ring: recent completed traces
                    # (summaries), `?trace_id=` for full span trees of
                    # every local trace under that id, `?slow=1` for the
                    # slow-query log. Trace SQL leaks literals → same
                    # auth gate as /queries.
                    if self._principal_session() is None:
                        return
                    from urllib.parse import parse_qs, urlparse

                    from snappydata_tpu_torch.observability.tracing import (
                        ring, tracing_snapshot)

                    q = parse_qs(urlparse(self.path).query)
                    tid = q.get("trace_id", [None])[0]
                    if tid:
                        self._send({"trace_id": tid,
                                    "traces": ring().get(tid)})
                        return
                    out = tracing_snapshot()
                    if q.get("slow", ["0"])[0] in ("1", "true"):
                        out["slow"] = ring().slow()
                    else:
                        try:
                            limit = int(q.get("limit", ["50"])[0])
                        except (TypeError, ValueError):
                            limit = 50
                        out["traces"] = ring().traces(limit)
                    self._send(out)
                elif path == "/status/api/v1/queries":
                    # query text leaks literals: same auth as /jobs
                    if self._principal_session() is None:
                        return
                    self._send(svc.session.recent_queries())
                elif path.startswith("/status/api/v1/queries/plan"):
                    # live plan view: EXPLAIN of a logged query on demand,
                    # under the REQUEST principal so table privileges apply
                    sess = self._principal_session()
                    if sess is None:
                        return
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        qid = int(q.get("id", q.get("idx", ["-1"]))[0])
                    except (TypeError, ValueError):
                        self._send({"error": "id must be an integer"}, 400)
                        return
                    entry = next((e for e in svc.session.recent_queries()
                                  if e["id"] == qid), None)
                    if entry is None:
                        self._send({"error": "no such query"}, 404)
                        return
                    try:
                        plan = sess.sql("EXPLAIN " + entry["sql"])
                        self._send({"sql": entry["sql"],
                                    "plan": [r[0] for r in plan.rows()]})
                    except Exception as e:  # noqa: BLE001
                        self._send({"error": str(e)}, 500)
                elif path == "/queries":
                    # live governed queries (running + queued) from the
                    # resource broker — query text leaks literals, so
                    # the same auth gate as /jobs applies
                    if self._principal_session() is None:
                        return
                    from snappydata_tpu_torch import resource

                    self._send(resource.global_broker().queries())
                elif path == "/queries/ledger":
                    if self._principal_session() is None:
                        return
                    from snappydata_tpu_torch import resource

                    self._send(resource.global_broker().ledger())
                elif path == "/faults":
                    # fault-injection surface (chaos tooling): armed
                    # failpoints + fire counts. Same admin gate as the
                    # POST side — fault state reveals operational detail
                    if self._admin_session("fault state") is None:
                        return
                    self._send({
                        "faults": _fault_list(),
                        "injected":
                            global_registry().counter("fault_injected")})
                elif path == "/metrics/json":
                    self._send(global_registry().snapshot())
                elif path == "/metrics/prometheus":
                    self._send(global_registry().to_prometheus().encode(),
                               content_type="text/plain")
                elif path in ("", "/dashboard"):
                    # shows recent query text → token-gated when auth on
                    if (svc.auth_tokens or svc.auth_provider is not None) \
                            and self._principal_session() is None:
                        return
                    self._send(_render_dashboard(svc).encode(),
                               content_type="text/html")
                elif path.startswith("/jobs/"):
                    # job results carry query rows: same auth as submission
                    if self._principal_session() is None:
                        return
                    st = svc.jobs.status(path.split("/")[-1])
                    self._send(st if st else {"error": "no such job"},
                               200 if st else 404)
                elif path == "/jobs":
                    if self._principal_session() is None:
                        return
                    self._send(svc.jobs.list())
                else:
                    self._send({"error": "not found"}, 404)

            def _admin_session(self, action_desc):
                """Operator-action gate: resolved principal, admin-only
                when auth is configured; None → 401/403 already sent."""
                sess = self._principal_session()
                if sess is None:
                    return None
                if (svc.auth_tokens or svc.auth_provider) and \
                        sess.user != "admin":
                    self._send({"error": f"{action_desc} requires "
                                         f"admin"}, 403)
                    return None
                return sess

            def _principal_session(self):
                """Resolve the request principal; None → 401 already sent."""
                auth = self.headers.get("Authorization", "")
                token = self.headers.get("X-Snappy-Token")
                if token is None and auth.startswith("Bearer "):
                    token = auth[len("Bearer "):]
                if not svc.auth_tokens and svc.auth_provider is None:
                    return svc.session.for_user(svc.session.user,
                                                authenticated=False)
                user = svc.auth_tokens.get(token) if token else None
                if user is None and svc.auth_provider is not None \
                        and auth.startswith("Basic "):
                    import base64
                    import hashlib
                    import time as _t
                    try:
                        raw = base64.b64decode(auth[len("Basic "):],
                                               validate=True)
                        u, _, p = raw.decode("utf-8").partition(":")
                    except Exception:
                        raw, u, p = b"", "", ""
                    digest = hashlib.sha256(raw).hexdigest()
                    now = _t.time()
                    cached = svc._basic_cache.get(digest)
                    if cached is not None and cached[0] == u \
                            and cached[1] > now:
                        user = u
                    elif u and p and svc.auth_provider.authenticate(u, p):
                        # short TTL: a revoked/changed credential stops
                        # working within BASIC_CACHE_TTL_S, not never
                        svc._basic_cache[digest] = (
                            u, now + svc.BASIC_CACHE_TTL_S)
                        user = u
                if user is None:
                    self._send({"error": "missing or invalid "
                                         "token/credentials"}, 401)
                    return None
                return svc.session.for_user(user, authenticated=True)

            def _post(self):
                path = self.path.rstrip("/")
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if path == "/jobs":
                    sess = self._principal_session()
                    if sess is None:
                        return
                    job_id = svc.jobs.submit_sql(
                        body["sql"], tuple(body.get("params", ())),
                        session=sess, timeout_s=body.get("timeout_s"))
                    self._send({"jobId": job_id, "status": "STARTED"})
                elif path == "/sql":
                    # synchronous query POST, routed through the serving
                    # executor: repeated statements hit the prepared-plan
                    # registry (compile-once) and concurrent requests of
                    # one shape fuse into a single device dispatch; the
                    # governor admits per request under the caller's
                    # principal
                    sess = self._principal_session()
                    if sess is None:
                        return
                    from snappydata_tpu_torch.observability import tracing

                    trace_id = None
                    try:
                        # per-request deadline: `timeout_s` in the body
                        # arms the QueryContext, so a stalled query stops
                        # cooperatively (XCL52) instead of holding the
                        # HTTP worker past the caller's patience
                        ctx = None
                        t = body.get("timeout_s")
                        if t:
                            from snappydata_tpu_torch import resource

                            ctx = resource.new_query(body["sql"],
                                                     user=sess.user)
                            ctx.set_deadline_in(float(t))
                        # REST is a front door: mint (or join, if the
                        # caller sent one) the request's trace id — it
                        # comes back in the response, and on errors, so
                        # a client-visible failure is joinable against
                        # /status/api/v1/traces
                        with tracing.request_scope(
                                body.get("sql", ""), user=sess.user,
                                kind="rest",
                                trace_id=body.get("trace_id")) as tr:
                            trace_id = tr.trace_id if tr else None
                            result = sess.serving_sql(
                                body["sql"],
                                tuple(body.get("params", ())),
                                query_ctx=ctx)
                        # JSON over HTTP is the small-result surface:
                        # cap the payload but SAY so — a silently
                        # truncated result reads as a complete one
                        # (bulk reads belong on Flight, which streams)
                        cap = 10000
                        payload = {
                            "names": result.names,
                            "rows": [[_j(v) for v in r]
                                     for r in result.rows()[:cap]],
                            "total_rows": result.num_rows,
                        }
                        if result.num_rows > cap:
                            payload["truncated"] = True
                        if trace_id:
                            payload["trace_id"] = trace_id
                        self._send(payload)
                    except (KeyError, TypeError) as e:
                        err = {"error": f"bad request: {e}"}
                        if trace_id:
                            err["trace_id"] = trace_id
                        self._send(err, 400)
                    except Exception as e:      # noqa: BLE001
                        err = {"error": str(e)}
                        if trace_id:
                            err["trace_id"] = trace_id
                        self._send(err, 400)
                elif path.startswith("/queries/") and \
                        path.endswith("/cancel"):
                    # cooperative cancel: flags the query's context; the
                    # engine stops it at the next batch/tile boundary.
                    # Non-admin principals may only cancel their own.
                    sess = self._principal_session()
                    if sess is None:
                        return
                    qid = path[len("/queries/"):-len("/cancel")]
                    from snappydata_tpu_torch import resource

                    # same is-not-None test as _principal_session: a
                    # falsy-but-configured provider must still gate
                    gate = sess.user if (svc.auth_tokens or
                                         svc.auth_provider is not None) \
                        else None
                    try:
                        ok = resource.global_broker().cancel(
                            qid, "cancelled via REST", user=gate)
                    except PermissionError as e:
                        self._send({"error": str(e)}, 403)
                        return
                    self._send({"queryId": qid, "cancelled": ok},
                               200 if ok else 404)
                elif path == "/faults":
                    # arm/disarm failpoints at runtime (the chaos
                    # harness's remote control). Injecting faults is an
                    # operator action: admin only when auth is on.
                    if self._admin_session("fault injection") is None:
                        return
                    from snappydata_tpu_torch.reliability import \
                        failpoints as reg

                    try:
                        if body.get("clear"):
                            reg.clear()
                        elif body.get("disarm"):
                            reg.disarm(body["name"])
                        elif "seed" in body and "name" not in body \
                                and "spec" not in body:
                            reg.reseed(int(body["seed"]))
                        elif "spec" in body:   # compact-grammar string
                            reg.arm_from_spec(body["spec"])
                        else:
                            def _opt(key, cast):
                                v = body.get(key)
                                return None if v is None else cast(v)
                            reg.arm(body["name"], body["action"],
                                    param=float(body.get("param", 0.0)),
                                    exc=body.get("exc", "io"),
                                    phase=body.get("phase", "before"),
                                    count=_opt("count", int),
                                    every=_opt("every", int),
                                    p=_opt("p", float))
                    except (KeyError, ValueError, TypeError) as e:
                        self._send({"error": f"bad fault spec: {e}"}, 400)
                        return
                    self._send({"faults": _fault_list()})
                elif path == "/wal/flush":
                    # durability barrier: drain+fsync the WAL commit
                    # buffer past any relaxed interval-mode ack — on the
                    # whole cluster when this lead has one, else locally
                    if self._admin_session("operator action") is None:
                        return
                    try:
                        if svc.distributed is not None:
                            self._send(svc.distributed.flush_wals())
                        elif svc.session.disk_store is not None:
                            svc.session.disk_store.wal_sync(force=True)
                            self._send({"flushed_members": 1,
                                        "durable_members": 1})
                        else:
                            self._send({"flushed_members": 0,
                                        "durable_members": 0})
                    except Exception as e:
                        self._send({"error": str(e)}, 500)
                elif path in ("/rebalance", "/redundancy/restore"):
                    # SYS.REBALANCE_ALL_BUCKETS analogue + redundancy
                    # re-restoration (operator actions; admin only when
                    # auth is on)
                    if self._admin_session("operator action") is None:
                        return
                    if svc.distributed is None:
                        self._send({"error": "no cluster session on "
                                             "this lead"}, 409)
                        return
                    try:
                        if path == "/rebalance":
                            self._send(svc.distributed.rebalance())
                        else:
                            self._send(
                                svc.distributed.restore_redundancy())
                    except Exception as e:
                        # both ops are restartable: report how they
                        # failed rather than aborting the connection
                        self._send({"error": str(e)}, 500)
                else:
                    self._send({"error": "not found"}, 404)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RestService":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
