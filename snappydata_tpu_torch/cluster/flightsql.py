"""Arrow Flight SQL protocol surface: wire-format messages + dispatch
(port of snappydata_tpu/cluster/flightsql.py; the same bytes on the wire).

The reference serves any JDBC/ODBC client through its thrift/DRDA network
servers (cluster/README-thrift.md:20-35). The equivalent here is Arrow
Flight SQL — the OPEN protocol that stock ADBC / JDBC-FlightSQL drivers
speak. This module implements the protobuf wire format of the
public `arrow.flight.protocol.sql` messages (hand-rolled varint codec —
the protocol is stable and tiny; no protobuf runtime needed) plus the
server-side dispatch used by SnappyFlightServer:

  GetFlightInfo(CommandStatementQuery)      → FlightInfo + ticket
  DoGet(TicketStatementQuery)               → result record batches
  GetFlightInfo/DoGet(CommandGetCatalogs / CommandGetDbSchemas /
      CommandGetTables)                     → spec-schema catalog rows
  DoAction(CreatePreparedStatement / ClosePreparedStatement)
  DoPut(CommandPreparedStatementQuery)      → bind '?' parameters
  GetFlightInfo/DoGet(CommandPreparedStatementQuery)
  DoPut(CommandStatementUpdate)             → DoPutUpdateResult

Message field numbers follow the public FlightSql.proto (apache/arrow,
format/FlightSql.proto); a conformance client lives in
`FlightSqlClient` below for tests and for environments without an ADBC
driver installed.
"""

from __future__ import annotations

import json
import threading
from snappydata_tpu_torch.utils import locks
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

_SQL_NS = "type.googleapis.com/arrow.flight.protocol.sql."


# ---------------------------------------------------------------------
# protobuf wire codec (varint + length-delimited only — all FlightSql
# messages use wire types 0 and 2)
# ---------------------------------------------------------------------

def _put_varint(out: bytearray, v: int) -> None:
    if v < 0:
        # proto varints are two's-complement over 64 bits: negative
        # int32/int64 values encode as 10 bytes (e.g. the spec'd
        # DoPutUpdateResult.record_count = -1 for 'unknown'). Without the
        # mask the arithmetic shift below never terminates.
        v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def varint_to_int64(v: int) -> int:
    """Decoded varints are raw unsigned 64-bit values; reinterpret as the
    signed int64 proto3 int32/int64 fields carry (-1 arrives as 2^64-1)."""
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


def _get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def encode_fields(fields: List[Tuple[int, object]]) -> bytes:
    """fields: (field_number, value) — str/bytes → length-delimited,
    int/bool → varint, list/tuple → REPEATED field (one entry per
    element). Nones AND proto3 defaults (0, False, empty str/bytes) are
    skipped for SINGULAR fields only — that is proto3 canonical
    serialization; a repeated-field element that happens to be a default
    value (e.g. an empty string in CommandGetTables.table_types) is a
    real element and must stay on the wire (advisor round 5). Matches
    the official runtime byte for byte (golden fixtures generated with
    google.protobuf — tests/test_flightsql_golden.py)."""
    out = bytearray()

    def put_one(num: int, val, skip_defaults: bool) -> None:
        if isinstance(val, bool):
            if skip_defaults and not val:
                return
            _put_varint(out, (num << 3) | 0)
            _put_varint(out, 1 if val else 0)
        elif isinstance(val, int):
            if skip_defaults and val == 0:
                return
            _put_varint(out, (num << 3) | 0)
            _put_varint(out, val)
        else:
            raw = val.encode("utf-8") if isinstance(val, str) else bytes(val)
            if skip_defaults and not raw:
                return
            _put_varint(out, (num << 3) | 2)
            _put_varint(out, len(raw))
            out.extend(raw)

    for num, val in fields:
        if val is None:
            continue
        if isinstance(val, (list, tuple)):
            for el in val:
                if el is not None:
                    put_one(num, el, skip_defaults=False)
        else:
            put_one(num, val, skip_defaults=True)
    return bytes(out)


def decode_fields(buf: bytes) -> Dict[int, list]:
    """→ {field_number: [raw values]} (varints as int, delimited as
    bytes)."""
    out: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _get_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _get_varint(buf, pos)
        elif wire == 2:
            ln, pos = _get_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(num, []).append(v)
    return out


def pack_any(msg_name: str, payload: bytes) -> bytes:
    """google.protobuf.Any {type_url=1, value=2}."""
    return encode_fields([(1, _SQL_NS + msg_name), (2, payload)])


def unpack_any(buf: bytes) -> Optional[Tuple[str, bytes]]:
    """→ (short message name, payload) when this is a FlightSql Any."""
    try:
        f = decode_fields(buf)
    except (IndexError, ValueError):
        return None
    urls = f.get(1)
    if not urls:
        return None
    url = urls[0].decode("utf-8", "replace")
    if not url.startswith(_SQL_NS):
        return None
    value = f.get(2, [b""])[0]
    return url[len(_SQL_NS):], value


def _s(f: Dict[int, list], num: int, default: Optional[str] = None):
    v = f.get(num)
    return v[0].decode("utf-8") if v else default


def _b(f: Dict[int, list], num: int) -> Optional[bytes]:
    v = f.get(num)
    return bytes(v[0]) if v else None


# ---------------------------------------------------------------------
# server-side dispatch
# ---------------------------------------------------------------------

class FlightSqlHandler:
    """FlightSQL request handling over a SnappySession provider.

    `session_for(body)` mirrors SnappyFlightServer._session_for: resolves
    the caller's authenticated session from headers already validated by
    the server middleware."""

    def __init__(self, server):
        self.server = server
        self._prepared: Dict[bytes, dict] = {}
        self._lock = locks.named_lock("flightsql.handles")
        self._next_handle = 0

    # -- helpers -------------------------------------------------------

    def _session(self, context):
        return self.server._session_from_context(context)

    def _catalog_rows(self, sess, kind: str, f: Dict[int, list]):
        """Spec-defined result sets for the catalog commands
        (FlightSql.proto: GetCatalogs/GetDbSchemas/GetTables schemas)."""
        if kind == "CommandGetCatalogs":
            return pa.table({"catalog_name": pa.array(["snappydata"],
                                                      pa.utf8())})
        if kind == "CommandGetDbSchemas":
            return pa.table({
                "catalog_name": pa.array(["snappydata"], pa.utf8()),
                "db_schema_name": pa.array(["app"], pa.utf8())})
        # CommandGetTables
        pattern = _s(f, 3)
        # repeated table_types (field 4): empty list = no filter; an
        # empty-string ELEMENT is a real (nothing-matching) filter
        # entry, preserved by the repeated-aware codec
        type_filter = {v.decode("utf-8", "replace").upper()
                       for v in f.get(4, [])}
        include_schema = bool(f.get(5, [0])[0])
        names, types, schemas = [], [], []
        if not type_filter or "TABLE" in type_filter:
            for info in sess.catalog.list_tables():
                nm = info.name
                if pattern and not _like_match(pattern, nm):
                    continue
                names.append(nm)
                types.append("TABLE")
                if include_schema:
                    fields = [pa.field(fl.name, _ARROW_OF(fl.dtype),
                                       fl.nullable)
                              for fl in info.schema.fields
                              if not fl.name.startswith("__")]
                    schemas.append(pa.schema(fields)
                                   .serialize().to_pybytes())
        if not type_filter or "VIEW" in type_filter:
            for vname in sorted(getattr(sess.catalog, "_views", {})):
                if pattern and not _like_match(pattern, vname):
                    continue
                names.append(vname)
                types.append("VIEW")
                if include_schema:
                    schemas.append(pa.schema([]).serialize().to_pybytes())
        cols = {
            "catalog_name": pa.array(["snappydata"] * len(names),
                                     pa.utf8()),
            "db_schema_name": pa.array(["app"] * len(names), pa.utf8()),
            "table_name": pa.array(names, pa.utf8()),
            "table_type": pa.array(types, pa.utf8()),
        }
        if include_schema:
            cols["table_schema"] = pa.array(schemas, pa.binary())
        return pa.table(cols)

    # -- GetFlightInfo -------------------------------------------------

    def flight_info(self, context, descriptor, kind: str, payload: bytes):
        import pyarrow.flight as flight

        f = decode_fields(payload)
        sess = self._session(context)
        if kind == "CommandStatementQuery":
            query = _s(f, 1, "")
            ticket_payload = pack_any(
                "TicketStatementQuery",
                encode_fields([(1, json.dumps({"sql": query})
                                .encode("utf-8"))]))
            schema = self._query_schema(sess, query, ())
        elif kind == "CommandPreparedStatementQuery":
            handle = _b(f, 1) or b""
            with self._lock:
                st = self._prepared.get(handle)
            if st is None:
                raise flight.FlightServerError(
                    "unknown prepared statement handle")
            ticket_payload = pack_any(kind, payload)
            schema = self._query_schema(sess, st["sql"],
                                        st.get("params", ()))
        elif kind in ("CommandGetCatalogs", "CommandGetDbSchemas",
                      "CommandGetTables"):
            ticket_payload = pack_any(kind, payload)
            schema = self._catalog_rows(sess, kind, f).schema
        else:
            raise flight.FlightServerError(
                f"unsupported FlightSQL command {kind}")
        endpoint = flight.FlightEndpoint(
            ticket_payload, [flight.Location(self.server._location)])
        return flight.FlightInfo(schema, descriptor, [endpoint], -1, -1)

    def _query_schema(self, sess, sql: str, params) -> "pa.Schema":
        # already-prepared shapes answer from the serving registry's
        # cached schema; everything else analyzes WITHOUT registering —
        # GetFlightInfo of ad-hoc literal-bearing SQL must not churn
        # real prepared handles out of the registry LRU
        schema = None
        try:
            from snappydata_tpu_torch.serving import registry_for

            handle = registry_for(sess.catalog).peek(sess, sql)
            if handle is not None:
                schema = handle.schema
        except Exception:
            schema = None
        if schema is None:
            schema = sess.query_schema(sql)
        return _widen_decimal_schema(pa.schema(
            [pa.field(fl.name, _ARROW_OF(fl.dtype), fl.nullable)
             for fl in schema.fields]))

    # -- DoGet ---------------------------------------------------------

    def do_get(self, context, kind: str, payload: bytes):
        import pyarrow.flight as flight

        from snappydata_tpu_torch.cluster.flight_server import result_to_arrow

        f = decode_fields(payload)
        sess = self._session(context)
        if kind == "TicketStatementQuery":
            body = json.loads((_b(f, 1) or b"{}").decode("utf-8"))
            result = sess.sql(body["sql"],
                              params=tuple(body.get("params", ())))
            table = _widen_decimal_table(result_to_arrow(result))
        elif kind == "CommandPreparedStatementQuery":
            handle = _b(f, 1) or b""
            with self._lock:
                st = self._prepared.get(handle)
            if st is None:
                raise flight.FlightServerError(
                    "unknown prepared statement handle")
            # serving registry: wire-level prepares get compile-once too
            # — the second execute of a handle is a serving_prepared_hits
            # hit, and concurrent executes fuse into one device dispatch
            result = sess.serving_sql(st["sql"],
                                      params=tuple(st.get("params", ())))
            table = _widen_decimal_table(result_to_arrow(result))
        elif kind in ("CommandGetCatalogs", "CommandGetDbSchemas",
                      "CommandGetTables"):
            table = self._catalog_rows(sess, kind, f)
        else:
            raise flight.FlightServerError(
                f"unsupported FlightSQL ticket {kind}")
        # 0-row results still need one (empty) batch carrying the schema;
        # pa.record_batch([], schema=non-empty-schema) raises — build the
        # empty arrays explicitly
        batches = table.to_batches(max_chunksize=65536) or \
            [pa.RecordBatch.from_arrays(
                [pa.array([], type=f.type) for f in table.schema],
                schema=table.schema)]
        return flight.GeneratorStream(table.schema, iter(batches))

    # -- DoAction ------------------------------------------------------

    def do_action(self, context, kind: str, payload: bytes):
        f = decode_fields(payload)
        sess = self._session(context)
        if kind == "ActionCreatePreparedStatementRequest":
            sql = _s(f, 1, "")
            with self._lock:
                self._next_handle += 1
                handle = f"ps{self._next_handle}".encode("utf-8")
                self._prepared[handle] = {"sql": sql, "params": ()}
            if sql.lstrip().lower().startswith(("select", "with",
                                                "values")):
                # an explicit wire-level prepare IS the registry's
                # reason to exist: build the compile-once entry now so
                # the first execute is already a serving hit
                try:
                    from snappydata_tpu_torch.serving import ServingError

                    try:
                        sess.prepare(sql)
                    except ServingError:
                        pass
                except Exception:   # schema path reports real errors
                    pass
                schema = self._query_schema(sess, sql, ())
            else:
                schema = pa.schema([])
            result = encode_fields([
                (1, handle), (2, schema.serialize().to_pybytes())])
            return [pack_any("ActionCreatePreparedStatementResult",
                             result)]
        if kind == "ActionClosePreparedStatementRequest":
            handle = _b(f, 1) or b""
            with self._lock:
                self._prepared.pop(handle, None)
            return [b""]
        import pyarrow.flight as flight

        raise flight.FlightServerError(
            f"unsupported FlightSQL action {kind}")

    # -- DoPut ---------------------------------------------------------

    def do_put(self, context, kind: str, payload: bytes, reader, writer):
        import pyarrow.flight as flight

        f = decode_fields(payload)
        sess = self._session(context)
        if kind == "CommandStatementUpdate":
            sql = _s(f, 1, "")
            result = sess.sql(sql)
            # spec: record_count = -1 means 'unknown' (statements like
            # DDL whose result carries no row count) — encoded as a
            # 10-byte two's-complement varint
            n = int(result.rows()[0][0]) if result.num_rows and \
                result.columns and np.issubdtype(
                    np.asarray(result.columns[0]).dtype, np.number) else -1
            writer.write(encode_fields([(1, n)]))   # DoPutUpdateResult
            return
        if kind == "CommandPreparedStatementQuery":
            handle = _b(f, 1) or b""
            with self._lock:
                st = self._prepared.get(handle)
            if st is None:
                raise flight.FlightServerError(
                    "unknown prepared statement handle")
            table = reader.read_all()
            if table.num_rows:
                row = [col[0].as_py() for col in table.columns]
                with self._lock:
                    st["params"] = tuple(row)
            writer.write(encode_fields([(1, handle)]))
            return
        raise flight.FlightServerError(
            f"unsupported FlightSQL DoPut {kind}")


def _widen_decimal_schema(schema: "pa.Schema") -> "pa.Schema":
    """FlightSQL surface only: decimals travel as decimal128(38, s) so
    the GetFlightInfo schema and the DoGet stream ALWAYS agree — the
    engine's int64-overflow fallback can produce totals wider than the
    declared precision, and stock drivers that pre-allocate readers
    from FlightInfo reject a stream whose types differ. (The plain
    Flight ticket surface keeps exact declared types — the in-repo
    client and the exchange path read the stream schema directly.)"""
    fields = []
    for f in schema:
        if pa.types.is_decimal(f.type) and f.type.precision < 38:
            f = pa.field(f.name, pa.decimal128(38, f.type.scale),
                         f.nullable)
        fields.append(f)
    return pa.schema(fields)


def _widen_decimal_table(table: "pa.Table") -> "pa.Table":
    wide = _widen_decimal_schema(table.schema)
    return table if wide == table.schema else table.cast(wide)


def _like_match(pattern: str, name: str) -> bool:
    """SQL LIKE pattern (% and _) matching for catalog filters."""
    import re

    rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
    return re.fullmatch(rx, name, re.IGNORECASE) is not None


def _ARROW_OF(dtype):
    from snappydata_tpu_torch.cluster.flight_server import _arrow_type

    return _arrow_type(dtype)


# ---------------------------------------------------------------------
# conformance client (tests / environments without an ADBC driver)
# ---------------------------------------------------------------------

class FlightSqlClient:
    """Protocol-conformant FlightSQL client: speaks the public message
    encoding over a plain pyarrow FlightClient — what an ADBC FlightSQL
    driver sends on the wire."""

    def __init__(self, address: str, user: Optional[str] = None,
                 password: Optional[str] = None):
        import pyarrow.flight as flight

        self._conn = flight.connect(f"grpc://{address}")
        self._opts = None
        if user is not None:
            import base64

            cred = base64.b64encode(
                f"{user}:{password}".encode("utf-8")).decode("ascii")
            self._opts = flight.FlightCallOptions(
                headers=[(b"authorization", b"Basic " + cred.encode())])

    def _info(self, kind: str, payload: bytes):
        import pyarrow.flight as flight

        desc = flight.FlightDescriptor.for_command(pack_any(kind, payload))
        return self._conn.get_flight_info(desc, self._opts)

    def _read(self, info):
        ticket = info.endpoints[0].ticket
        return self._conn.do_get(ticket, self._opts).read_all()

    def execute(self, sql: str) -> pa.Table:
        info = self._info("CommandStatementQuery",
                          encode_fields([(1, sql)]))
        return self._read(info)

    def execute_update(self, sql: str) -> int:
        import pyarrow.flight as flight

        desc = flight.FlightDescriptor.for_command(
            pack_any("CommandStatementUpdate", encode_fields([(1, sql)])))
        writer, reader = self._conn.do_put(
            desc, pa.schema([]), self._opts)
        writer.done_writing()
        buf = reader.read()
        writer.close()
        if buf is None:
            return 0
        f = decode_fields(buf.to_pybytes())
        return varint_to_int64(int(f.get(1, [0])[0]))

    def get_tables(self, pattern: Optional[str] = None,
                   include_schema: bool = False,
                   table_types: Optional[Sequence[str]] = None) -> pa.Table:
        payload = encode_fields([(3, pattern),
                                 (4, list(table_types or ())),
                                 (5, include_schema)])
        return self._read(self._info("CommandGetTables", payload))

    def get_catalogs(self) -> pa.Table:
        return self._read(self._info("CommandGetCatalogs", b""))

    def get_db_schemas(self) -> pa.Table:
        return self._read(self._info("CommandGetDbSchemas", b""))

    def prepare(self, sql: str) -> "PreparedStatement":
        import pyarrow.flight as flight

        results = list(self._conn.do_action(
            flight.Action("CreatePreparedStatement",
                          pack_any("ActionCreatePreparedStatementRequest",
                                   encode_fields([(1, sql)]))),
            self._opts))
        got = unpack_any(results[0].body.to_pybytes())
        assert got is not None and \
            got[0] == "ActionCreatePreparedStatementResult"
        f = decode_fields(got[1])
        return PreparedStatement(self, _b(f, 1) or b"")

    def close(self) -> None:
        self._conn.close()


class PreparedStatement:
    def __init__(self, client: FlightSqlClient, handle: bytes):
        self.client = client
        self.handle = handle

    def execute(self, params: Sequence = ()) -> pa.Table:
        import pyarrow.flight as flight

        payload = encode_fields([(1, self.handle)])
        if params:
            desc = flight.FlightDescriptor.for_command(
                pack_any("CommandPreparedStatementQuery", payload))
            arrays = [pa.array([p]) for p in params]
            names = [f"p{i}" for i in range(len(params))]
            tbl = pa.table(dict(zip(names, arrays)))
            writer, reader = self.client._conn.do_put(
                desc, tbl.schema, self.client._opts)
            writer.write_table(tbl)
            writer.done_writing()
            reader.read()
            writer.close()
        info = self.client._info("CommandPreparedStatementQuery", payload)
        return self.client._read(info)

    def close(self) -> None:
        import pyarrow.flight as flight

        list(self.client._conn.do_action(
            flight.Action("ClosePreparedStatement",
                          pack_any("ActionClosePreparedStatementRequest",
                                   encode_fields([(1, self.handle)]))),
            self.client._opts))
