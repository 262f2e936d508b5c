"""Device decode and the dictionary-domain batch skipper of the port:

- all of tests/test_device_decode.py run against the port with the
  reference's assertions (`torch_parity.port_cases`): RLE, bitset and
  VALUE_DICT batches bound in the compressed domain, the transfer
  counters, deltas falling back to a host decode, persistence;
- fault C8: after an UPDATE of a VALUE_DICT column the skipper probed the
  batch's stale dictionary, so `qty = 999.0` found none of the 25 updated
  rows; a batch whose deltas touch the column is now always kept, as in
  the reference (`_dict_domain`).  Held against the reference under both
  plate policies."""

import numpy as np
import pytest

from torch_parity import (POLICIES, Pair, _ledger_per_test,  # noqa: F401
                          case_names, front_door_env, port_cases)

globals().update(port_cases("test_device_decode.py",
                            case_names("test_device_decode.py")))


def _valdict_pair(name, n=60_000):
    p = Pair(name)
    p.sql("CREATE TABLE vd_t (k BIGINT, qty DOUBLE, price DOUBLE) "
          "USING column")
    rng = np.random.default_rng(7)
    k = np.arange(n, dtype=np.int64)
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(rng.uniform(900.0, 105_000.0, n), 2)
    p.insert_arrays("vd_t", [k, qty, price])
    for s in (p.port, p.ref):
        s.catalog.describe("vd_t").data.force_rollover()
    return p, k, qty


@pytest.mark.parametrize("name", POLICIES)
def test_value_dict_skipper_sees_update_deltas(name):
    p, k, qty = _valdict_pair(name)
    # warm the pre-update bind, so a stale probe surface could be reused
    p.device("SELECT count(*) FROM vd_t WHERE qty = 17.0")
    p.sql("UPDATE vd_t SET qty = 999.0 WHERE k < 25")
    assert p.device("SELECT count(*) FROM vd_t WHERE qty = 999.0") \
        == [(25,)]
    # a batch no delta touches keeps its skipping, and its rows
    rows = p.device("SELECT count(*) FROM vd_t WHERE qty = 17.0")
    assert rows == [(int((qty[25:] == 17.0).sum()),)]
    assert p.device("SELECT count(*) FROM vd_t WHERE qty = 1000.0") \
        == [(0,)]
    rows = p.device("SELECT max(qty), sum(qty) FROM vd_t")
    assert rows[0][0] == 999.0
    assert rows[0][1] == pytest.approx(float(qty[25:].sum()) + 25 * 999.0)


@pytest.mark.parametrize("name", POLICIES)
def test_value_dict_skipper_after_update_of_another_column(name):
    p, k, qty = _valdict_pair(name)
    p.sql("UPDATE vd_t SET price = 1.0 WHERE k < 25")
    rows = p.device("SELECT count(*), sum(price) FROM vd_t "
                    "WHERE qty = 17.0")
    assert rows[0][0] == int((qty == 17.0).sum())
