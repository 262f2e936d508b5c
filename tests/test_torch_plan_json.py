"""Plan JSON through the port (snappydata_tpu_torch/sql/plan_json.py), the
body of a Flight `plan` ticket: every TPC-H query of `utils/tpch.py`
(Q15 through its view) parses to a plan whose JSON is the reference's
byte for byte and round-trips to an equal plan; the reference's
`to_json` of each plan, shipped through the reference's client to the
port's Flight server, executes there with the reference's rows."""

import json
import threading

import numpy as np
import pytest

from torch_parity import (_ledger_per_test, assert_rows_equal,  # noqa: F401
                          front_door_env, stop_flight)

from snappydata_tpu.sql import plan_json as ref_plan_json
from snappydata_tpu.sql.parser import parse as ref_parse
from snappydata_tpu_torch.sql import plan_json
from snappydata_tpu_torch.sql.parser import parse
from snappydata_tpu_torch.utils import tpch

QUERY_IDS = sorted(tpch.ALL_QUERIES)


@pytest.mark.parametrize("qid", QUERY_IDS)
def test_plan_round_trips_with_the_reference_wire(qid):
    q = tpch.ALL_QUERIES[qid]
    plan = parse(q).plan
    wire = plan_json.to_json(plan)
    assert json.loads(json.dumps(wire)) == wire
    assert plan_json.from_json(wire) == plan
    # the same JSON as the reference's encoder of the reference's parse
    assert json.dumps(wire, sort_keys=True) == json.dumps(
        ref_plan_json.to_json(ref_parse(q).plan), sort_keys=True)


def test_decoder_refuses_foreign_types():
    with pytest.raises(plan_json.PlanCodecError):
        plan_json.from_json({"_t": "Popen", "args": "x"})
    with pytest.raises(plan_json.PlanCodecError):
        plan_json.to_json(object())


@pytest.fixture(scope="module")
def shipped():
    """A reference session and a port session, each behind its package's
    Flight server, loaded with the same TPC-H tables (sf 0.002, all
    tables, Q15's view); one reference client for each."""
    from snappydata_tpu import SnappySession as RefSession
    from snappydata_tpu.catalog import Catalog as RefCatalog
    from snappydata_tpu.cluster.client import SnappyClient
    from snappydata_tpu.cluster.flight_server import \
        SnappyFlightServer as RefServer
    from snappydata_tpu.utils import tpch as ref_tpch
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.cluster.flight_server import SnappyFlightServer

    ref = RefSession(catalog=RefCatalog())
    port = SnappySession(catalog=Catalog(), device="cpu")
    ref_tpch.load_tpch(ref, sf=0.002, all_tables=True)
    tpch.load_tpch(port, sf=0.002, all_tables=True)
    for s in (ref, port):
        s.sql(tpch.Q15_VIEW)
    servers = [RefServer(ref), SnappyFlightServer(port)]
    for srv in servers:
        threading.Thread(target=srv.serve, daemon=True).start()
        srv.wait_ready()
    clients = [SnappyClient(address=f"127.0.0.1:{srv.port}")
               for srv in servers]
    yield ref, clients[0], clients[1]
    for c in clients:
        c.close()
    for srv in servers:
        stop_flight(srv)
    ref.stop()
    port.stop()


def _table_rows(t):
    cols = [t.column(i).to_pylist() for i in range(t.num_columns)]
    return [tuple(r) for r in zip(*cols)] if cols else []


@pytest.mark.parametrize("qid", QUERY_IDS)
def test_reference_plan_runs_on_port_server(shipped, qid):
    """The reference's plan JSON through the port's server gives the
    Arrow table the reference's server gives for it (schema equal, sums
    within the parity bar), and the reference session's own rows where
    the output names are distinct (the wire table keys columns by name:
    Q7's two `n_name` columns come back as one from either server)."""
    ref, ref_client, port_client = shipped
    q = tpch.ALL_QUERIES[qid]
    payload = ref_plan_json.to_json(ref_parse(q).plan)
    got = port_client.plan(payload)
    want = ref_client.plan(payload)
    assert got.schema == want.schema
    assert_rows_equal(_table_rows(got), _table_rows(want), 1e-9)
    local = ref.sql(q)
    if len(set(local.names)) == len(local.names):
        assert_rows_equal(_table_rows(got), [
            tuple(float(v) if isinstance(v, np.floating) else v for v in r)
            for r in local.rows()], 1e-9)
