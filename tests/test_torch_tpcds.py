"""The TPC-DS kit of the port (snappydata_tpu_torch/utils/tpcds.py):

- all of tests/test_tpcds.py run against the port with the reference's
  assertions (`torch_parity.port_cases`): q3 and q6 against pandas, the
  reporting family's order and totals, q36's ROLLUP rows and q98's ratios
  (its distributed case keeps the reference's `slow` mark);
- the generators bit-identical across packages at sf 0.003;
- the eight queries through both packages on the kit each package ships,
  rows equal under the parity bar and equal routing counters, under both
  plate policies."""

import numpy as np
import pytest

from snappydata_tpu.utils import tpcds as ref_tpcds
from snappydata_tpu_torch.utils import tpcds
from torch_parity import (POLICIES, Pair, _ledger_per_test,  # noqa: F401
                          case_names, front_door_env, policy, port_cases)

globals().update(port_cases("test_tpcds.py", case_names("test_tpcds.py")))

SF, SEED = 0.003, 11


def _generated(kit, sf=SF, seed=SEED):
    sz = kit.table_sizes(sf)
    dd = kit.gen_date_dim(seed=seed)
    return {
        "date_dim": dd,
        "item": kit.gen_item(sz["item"], seed + 1),
        "customer": kit.gen_customer(sz["customer"],
                                     sz["customer_address"], seed + 2),
        "customer_address": kit.gen_customer_address(
            sz["customer_address"], seed + 3),
        "store": kit.gen_store(sz["store"], seed + 4),
        "store_sales": kit.gen_store_sales(
            sz["store_sales"], len(dd["d_date_sk"]), sz["item"],
            sz["customer"], sz["store"], seed + 5),
    }


def test_generators_bit_identical_across_packages():
    assert tpcds.table_sizes(SF) == ref_tpcds.table_sizes(SF)
    assert tpcds.table_sizes(10) == ref_tpcds.table_sizes(10)
    got, want = _generated(tpcds), _generated(ref_tpcds)
    assert list(got) == list(want)
    for table in want:
        assert list(got[table]) == list(want[table]), table
        for col, w in want[table].items():
            g = got[table][col]
            assert g.dtype == w.dtype, (table, col)
            if w.dtype == object:
                assert g.tolist() == w.tolist(), (table, col)
            else:
                assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), \
                    (table, col)
    assert tpcds.QUERIES == ref_tpcds.QUERIES


@pytest.fixture(scope="module", params=POLICIES)
def pair(request):
    p = Pair(request.param)
    with policy(p.policy):
        tpcds.load_tpcds(p.port, sf=SF, seed=SEED)
        ref_tpcds.load_tpcds(p.ref, sf=SF, seed=SEED)
    yield p
    p.port.stop()
    p.ref.stop()


@pytest.mark.parametrize("qname", sorted(tpcds.QUERIES))
def test_query_rows_equal_the_references(pair, qname):
    rows, _moved = pair.run(tpcds.QUERIES[qname])
    assert rows, qname
