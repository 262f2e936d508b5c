"""Pre-admission cost estimation: rows x decoded width from catalog stats.

Port of snappydata_tpu/resource/estimate.py, with the same numbers.  The
broker needs a memory estimate BEFORE a query runs (the reference sizes
column batches from catalog stats before admitting work against
critical-heap-percentage).  The estimate is deliberately simple and
conservative: for every referenced table, row count times decoded row
width (device dtype bytes per numeric column, 4-byte dictionary codes per
string, one validity byte per column), summed over the referenced tables:
the bytes a full decoded bind of each scan would occupy.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.sql import ast


def _decoded_row_width(schema: T.Schema) -> int:
    width = 0
    for f in schema.fields:
        if isinstance(f.dtype, (T.ArrayType, T.MapType, T.StructType)):
            width += 64          # nested plates: coarse per-row charge
        elif f.dtype.name == "string":
            width += 4           # dictionary code (int32)
        else:
            try:
                width += np.dtype(f.dtype.device_dtype()).itemsize
            except Exception:
                width += 8
        width += 1               # validity byte
    return width


def _referenced_tables(plan: ast.Plan, out: Set[str]) -> None:
    if isinstance(plan, (ast.Relation, ast.UnresolvedRelation)):
        out.add(plan.name.lower())
    for e in ast.plan_exprs(plan):
        for x in ast.walk(e):
            if isinstance(x, (ast.ScalarSubquery, ast.InSubquery,
                              ast.ExistsSubquery)):
                _referenced_tables(x.plan, out)
    for k in plan.children():
        _referenced_tables(k, out)


def _table_rows(info) -> int:
    data = info.data
    m = getattr(data, "snapshot", None)
    if m is not None:
        snap = m()
        if hasattr(snap, "total_rows"):  # column table manifest
            return int(snap.total_rows())
    live = getattr(data, "_live", None)  # row table liveness list
    if live is not None:
        return int(live.count(True))
    return 0


def estimate_query_bytes(catalog, plan: ast.Plan) -> int:
    """Bytes a decoded full bind of every referenced table would take.
    Unknown tables (views, CTEs) contribute 0: admission is a guard
    rail, not an oracle."""
    names: Set[str] = set()
    try:
        _referenced_tables(plan, names)
    except Exception:
        return 0
    total = 0
    for nm in names:
        info = catalog.lookup_table(nm)
        if info is None:
            continue
        try:
            total += _table_rows(info) * _decoded_row_width(info.schema)
        except Exception:
            continue
    return int(total)


def estimate_statement_bytes(catalog, stmt) -> int:
    plan = getattr(stmt, "plan", None)
    if plan is None:
        return 0
    return estimate_query_bytes(catalog, plan)


__all__: List[str] = ["estimate_query_bytes", "estimate_statement_bytes"]
