"""TPC-H Q6 and Q1 in the compressed domain: the loaded lineitem table's
code plates straight into the fused kernels.

The counterpart of the reference bench's compressed-domain lane
(bench.py `_pallas_fused_bench`, without its timing).  Both entry points
bind lineitem's columns 4-10 through `build_device_table`, where
l_quantity, l_discount and l_tax stay resident as VALUE_DICT code plates
(`CodePlate`), and then:

- `code_domain_q6` translates Q6's literals into per-batch code
  thresholds on the host — `np.searchsorted` over each batch's sorted
  float64 dictionary domain (`DeviceTable.dict_domains`), quantity `< 24`
  on the left side, discount `>= 0.05` left and `<= 0.07` as
  right-minus-one — and calls `fused_code_filter_sum`;
- `code_domain_q1` builds the group index from the two string code plates
  (`returnflag * |linestatus| + linestatus`, int32), transforms the
  discount and tax dictionaries on the host in float64 (`1 - disc`,
  `1 + tax`) before casting them to float32, and calls
  `grouped_code_reduce` with Q1's count and four sums.

The thresholds come from the float64 host domain, searched at the width
the engine compares at: `session.sql` compares the plate's dictionary
values with the session's float literal in their promoted type
(`code_cmp_mask`), so both the domain (first rounded to the plate's
dtype) and the literal are rounded to that type before the search.
Under float32 plates 0.05 and 0.07 are 0.0500000007 and 0.0700000003
there, and whether the stored dictionary holds those or the exact
float64 values depends on the width the batch was encoded at; searching
any other way moves a 0.05 or 0.07 boundary and drops a third of Q6's
rows.  (The reference bench's lane searches the unrounded literal and
disagrees with its own engine under float32 plates.)  A batch without a
dictionary (a padded batch) gets threshold 0 and matches nothing.

`fused_code_filter_sum` and `grouped_code_reduce` are module attributes
so a caller (chip_smoke.py) can wrap them to see the inputs the kernels
receive.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch.ops.group_reduce import grouped_code_reduce
from snappydata_tpu_torch.ops.kahan_reduce import fused_code_filter_sum
from snappydata_tpu_torch.storage.device import build_device_table
from snappydata_tpu_torch.storage.device_decode import CodePlate, promote
from snappydata_tpu_torch.utils.tpch import _days

QTY, PRICE, DISC, TAX, RF, LS, SHIP = 4, 5, 6, 7, 8, 9, 10


def _bind(session):
    """lineitem's columns 4-10 on the session's device; raises when a
    measure column is not code-bound."""
    data = session.catalog.lookup_table("lineitem").data
    with config.device_scope(session.device):
        dt = build_device_table(data, [QTY, PRICE, DISC, TAX, RF, LS, SHIP],
                                session.device)
    if not all(isinstance(dt.columns[c], CodePlate)
               for c in (QTY, DISC, TAX)):
        raise RuntimeError("lineitem measure columns are not code-bound "
                           "(scan_compressed_domain off?)")
    return dt


def _thresholds(dt, ci: int, lit: float, side: str) -> np.ndarray:
    """Per-batch int32 code threshold of `lit`: searchsorted over each
    batch's sorted dictionary, domain and literal both at the engine's
    compare width; 0 for a batch without a dictionary."""
    plate_t = dt.columns[ci].dicts.dtype
    lit_t = torch.float64 if config.use_float64() else torch.float32
    width = promote(plate_t, lit_t)
    dom, sizes = dt.dict_domains[ci]
    dom = torch.from_numpy(dom).to(plate_t).to(width).contiguous()
    lit = torch.full((dom.shape[0], 1), lit, dtype=width)
    pos = torch.searchsorted(dom, lit, side=side)[:, 0]
    # rows pad by repeating their last entry, so a position past a row's
    # real entries is its size, as a search over the real entries gives
    return torch.minimum(pos, torch.from_numpy(sizes)).to(torch.int32) \
        .numpy()


def q6_inputs(session) -> tuple:
    """The arguments of `fused_code_filter_sum` for Q6 over lineitem."""
    dt = _bind(session)
    dev = session.device
    qp, dp = dt.columns[QTY], dt.columns[DISC]
    with config.device_scope(dev):
        qhi = _thresholds(dt, QTY, 24.0, "left")
        dlo = _thresholds(dt, DISC, 0.05, "left")
        dhi = _thresholds(dt, DISC, 0.07, "right") - 1
    return (qp.codes, dp.codes, dt.columns[SHIP], dt.columns[PRICE],
            dt.valid, dp.dicts, *(torch.from_numpy(t).to(dev)
                                  for t in (qhi, dlo, dhi)),
            _days("1994-01-01"), _days("1995-01-01"))


def code_domain_q6(session) -> Tuple[float, int]:
    """Q6 through the fused code-filter kernel: (revenue, row count)."""
    total, count = fused_code_filter_sum(*q6_inputs(session))
    return float(total), int(count)


def q1_inputs(session) -> tuple:
    """(gidx, mask, slots, G, keys) for Q1 over lineitem: the arguments
    of `grouped_code_reduce` and the (returnflag, linestatus) of each
    group."""
    dt = _bind(session)
    dev = session.device
    qp, dp, tp = dt.columns[QTY], dt.columns[DISC], dt.columns[TAX]
    rfd, lsd = dt.dictionaries[RF], dt.dictionaries[LS]
    nls = max(1, len(lsd))
    G = max(1, len(rfd)) * nls
    gidx = dt.columns[RF] * nls + dt.columns[LS]
    mask = dt.valid & (dt.columns[SHIP] <= _days("1998-12-01") - 90)
    price = dt.columns[PRICE]

    def dictionary(host_f64):
        # transformed in float64 on the host, then cast, as the reference
        # kernel's wrapper casts its host dictionaries
        return torch.from_numpy(
            np.ascontiguousarray(host_f64, dtype=np.float32)).to(dev)

    qdict = dictionary(dt.dict_domains[QTY][0])
    one_minus_disc = dictionary(1.0 - dt.dict_domains[DISC][0])
    one_plus_tax = dictionary(1.0 + dt.dict_domains[TAX][0])
    slots = [("count",),
             ("sum", None, [(qp.codes, qdict)]),
             ("sum", price, []),
             ("sum", price, [(dp.codes, one_minus_disc)]),
             ("sum", price, [(dp.codes, one_minus_disc),
                             (tp.codes, one_plus_tax)])]
    keys = [(str(rfd[g // nls]), str(lsd[g % nls])) for g in range(G)]
    return gidx, mask, slots, G, keys


def code_domain_q1(session) -> List[tuple]:
    """Q1 through the grouped code kernel: one entry per (returnflag,
    linestatus) pair of the dictionaries, (returnflag, linestatus,
    count, sum_qty, sum_base_price, sum_disc_price, sum_charge), sorted
    by key; pairs with no row carry count 0."""
    gidx, mask, slots, G, keys = q1_inputs(session)
    outs = [o.cpu() for o in grouped_code_reduce(gidx, mask, slots, G)]
    rows = [keys[g] + (int(outs[0][g]),)
            + tuple(float(o[g]) for o in outs[1:]) for g in range(G)]
    return sorted(rows, key=lambda r: r[:2])
