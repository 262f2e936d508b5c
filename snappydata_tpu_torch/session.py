"""SnappySession — the user entry point of the PyTorch port.

Port of snappydata_tpu/session.py, cut to the analytic scan: `sql()`
for CREATE TABLE ... USING column, INSERT ... VALUES / SELECT, DROP,
TRUNCATE, SHOW / DESCRIBE, SET and queries; `insert` / `insert_arrays`
for bulk ingest.  A query runs parse -> optimize -> analyze -> tokenize
literals -> executor (ref: SnappySession.sqlPlan:2571).  Durability,
tiled and mesh execution, subqueries, views, samples and streams are not
ported and raise NotImplementedError.

A session runs on one torch device: `cuda` unless the caller asks for
another (`SnappySession(device="cpu")`).  Without a GPU, a session that
did not ask for the CPU raises instead of moving there silently.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.engine import hosteval
from snappydata_tpu_torch.engine.executor import Executor
from snappydata_tpu_torch.engine.result import (Result, empty_result,
                                                finalize_decimals,
                                                to_host_domain)
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.analyzer import (Analyzer,
                                               assign_param_positions,
                                               tokenize_plan)
from snappydata_tpu_torch.sql.optimizer import optimize
from snappydata_tpu_torch.sql.parser import parse
from snappydata_tpu_torch.utils import locks


def resolve_device(device=None) -> torch.device:
    """The session's torch device: `cuda` by default; raises when CUDA is
    absent and the caller did not ask for the CPU."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "session on the CPU")
    return dev


class SnappySession:
    """One user session.  Sessions share a process-local default catalog
    unless one is passed, mirroring embedded mode."""

    _default_catalog: Optional[Catalog] = None
    _default_lock = locks.named_lock("session.default_registry")

    def __init__(self, catalog: Optional[Catalog] = None, conf=None,
                 device=None):
        self.device = resolve_device(device)
        if catalog is None:
            with SnappySession._default_lock:
                if SnappySession._default_catalog is None:
                    SnappySession._default_catalog = Catalog()
                catalog = SnappySession._default_catalog
        self.catalog = catalog
        self.conf = conf or config.global_properties()
        self.analyzer = Analyzer(catalog)
        self.executor = Executor(catalog, self.conf, self.device)

    def sql(self, sql_text: str, params: Sequence[Any] = ()) -> Result:
        # storage encodes DOUBLE at the device width and the expression
        # lowering picks float widths from the device: every statement
        # runs inside the session's device scope
        with config.device_scope(self.device):
            stmt = parse(sql_text)
            if isinstance(stmt, ast.Query):
                if stmt.with_error is not None:
                    raise NotImplementedError(
                        "WITH ERROR (approximate queries) is not ported")
                return finalize_decimals(
                    self._run_query(stmt.plan, tuple(params)))
            return self._execute_statement(stmt, tuple(params))

    def _execute_statement(self, stmt: ast.Statement, params) -> Result:
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            self.catalog.drop_table(stmt.name, stmt.if_exists)
            return _status()
        if isinstance(stmt, ast.TruncateTable):
            self.catalog.describe(stmt.name).data.truncate()
            return _status()
        if isinstance(stmt, ast.InsertInto):
            return _count_result(self._insert(stmt, params))
        if isinstance(stmt, ast.ShowTables):
            infos = self.catalog.list_tables()
            return Result(
                ["tableName", "provider", "rowCount"],
                [np.array([i.name for i in infos], dtype=object),
                 np.array([i.provider for i in infos], dtype=object),
                 np.array([i.data.snapshot().total_rows() for i in infos],
                          dtype=np.int64)],
                [None, None, None], [T.STRING, T.STRING, T.LONG])
        if isinstance(stmt, ast.DescribeTable):
            fields = self.catalog.describe(stmt.name).schema.fields
            return Result(
                ["col_name", "data_type", "nullable"],
                [np.array([f.name for f in fields], dtype=object),
                 np.array([str(f.dtype) for f in fields], dtype=object),
                 np.array([f.nullable for f in fields])],
                [None, None, None], [T.STRING, T.STRING, T.BOOLEAN])
        if isinstance(stmt, ast.SetConf):
            self.conf.set(stmt.key, stmt.value)
            return _status()
        raise NotImplementedError(
            f"{type(stmt).__name__} is not ported to snappydata_tpu_torch")

    def _run_query(self, plan: ast.Plan, user_params=()) -> Result:
        if _contains_subquery(plan):
            raise NotImplementedError("subqueries are not ported")
        plan = optimize(plan, self.catalog)
        resolved, _ = self.analyzer.analyze_plan(plan)
        if self.conf.tokenize and self.conf.plan_caching:
            tokenized, lit_params = tokenize_plan(resolved)
        else:
            tokenized, lit_params = assign_param_positions(resolved, 0), ()
        return self.executor.execute(tokenized,
                                     tuple(lit_params) + tuple(user_params))

    # ------------------------------------------------------------------
    # Programmatic API (ref SnappySession.createTable/insert)
    # ------------------------------------------------------------------

    def create_table(self, name: str, schema, provider: str = "column",
                     options: Optional[Dict[str, str]] = None,
                     if_not_exists: bool = False):
        if not isinstance(schema, T.Schema):
            schema = T.Schema([T.Field(n, dt) for n, dt in schema])
        return self.catalog.create_table(name, schema, provider,
                                         options or {}, if_not_exists)

    def insert(self, table: str, *rows) -> int:
        info = self.catalog.describe(table)
        with config.device_scope(self.device):
            arrays, nulls = _rows_to_arrays(info.schema, rows)
            return info.data.insert_arrays(arrays, nulls=nulls)

    def insert_arrays(self, table: str, arrays: Sequence[np.ndarray]) -> int:
        info = self.catalog.describe(table)
        with config.device_scope(self.device):
            return info.data.insert_arrays([np.asarray(a) for a in arrays])

    def stop(self) -> None:
        self.executor.clear_cache()

    def clear_plan_cache(self) -> None:
        self.executor.clear_cache()

    def _create_table(self, stmt: ast.CreateTable) -> Result:
        if stmt.stream or stmt.provider != "column":
            raise NotImplementedError(
                "only CREATE TABLE ... USING column is ported")
        if stmt.as_select is not None:
            if stmt.if_not_exists and \
                    self.catalog.lookup_table(stmt.name) is not None:
                return _status()
            result = to_host_domain(self._run_query(stmt.as_select))
            schema = T.Schema([T.Field(n, dt) for n, dt in
                               zip(result.names, result.dtypes)])
            info = self.catalog.create_table(stmt.name, schema, "column",
                                             stmt.options,
                                             stmt.if_not_exists)
            if result.num_rows:
                arrays, nulls = _result_to_arrays(result, schema)
                info.data.insert_arrays(arrays, nulls=nulls)
            return _status()
        schema = T.Schema([T.Field(c.name, c.dtype, c.nullable)
                           for c in stmt.columns])
        self.catalog.create_table(stmt.name, schema, "column",
                                  stmt.options, stmt.if_not_exists)
        return _status()

    def _insert(self, stmt: ast.InsertInto, user_params) -> int:
        if stmt.put:
            raise NotImplementedError("PUT INTO is not ported")
        info = self.catalog.describe(stmt.table)
        schema = info.schema
        if isinstance(stmt.source, ast.Values):
            resolved, _ = self.analyzer.analyze_plan(stmt.source)
            src = hosteval.eval_values(resolved, user_params)
        else:
            src = to_host_domain(self._run_query(stmt.source, user_params))
        if stmt.columns:
            if len(stmt.columns) != len(src.columns):
                raise ValueError("INSERT column count mismatch")
            name_to_src = {c.lower(): i for i, c in enumerate(stmt.columns)}
        else:
            if len(src.columns) != len(schema):
                raise ValueError(
                    f"INSERT arity mismatch: {len(src.columns)} vs "
                    f"{len(schema)}")
            name_to_src = {f.name.lower(): i
                           for i, f in enumerate(schema.fields)}
        arrays, null_masks = [], []
        n = src.num_rows
        for f in schema.fields:
            i = name_to_src.get(f.name.lower())
            if i is None:  # unmentioned column -> all NULL
                arrays.append(np.zeros(n, dtype=f.dtype.np_dtype)
                              if f.dtype.name != "string"
                              else np.full(n, None, dtype=object))
                null_masks.append(np.ones(n, dtype=np.bool_))
                continue
            arr, nmask = _coerce(src.columns[i], src.nulls[i], f.dtype)
            arrays.append(arr)
            null_masks.append(nmask)
        if stmt.overwrite:
            info.data.truncate()
        return info.data.insert_arrays(arrays, nulls=null_masks)


def _status() -> Result:
    return empty_result(["status"], [T.STRING])


def _count_result(n: int) -> Result:
    return Result(["count"], [np.array([n], dtype=np.int64)], [None],
                  [T.LONG])


def _rows_to_arrays(schema: T.Schema, rows):
    if len(rows) == 1 and isinstance(rows[0], (list, tuple)) and rows[0] \
            and isinstance(rows[0][0], (list, tuple)):
        rows = rows[0]
    arrays, nulls = [], []
    for i, f in enumerate(schema.fields):
        vals = [r[i] for r in rows]
        nmask = np.array([v is None for v in vals])
        if f.dtype.name == "string":
            arr = np.empty(len(vals), dtype=object)
            for j, v in enumerate(vals):
                arr[j] = v
            arrays.append(arr)
        else:
            arrays.append(np.array(
                [0 if v is None else v for v in vals], dtype=f.dtype.np_dtype))
        nulls.append(nmask if nmask.any() else None)
    return arrays, nulls


def _result_to_arrays(result: Result, schema: T.Schema):
    arrays, nulls = [], []
    for i, f in enumerate(schema.fields):
        arr, nmask = _coerce(result.columns[i], result.nulls[i], f.dtype)
        arrays.append(arr)
        nulls.append(nmask)
    return arrays, nulls


def _coerce(col: np.ndarray, nmask, dtype: T.DataType):
    """-> (storage array, null mask | None): NULLs become fillers + mask
    instead of being silently written as 0."""
    if dtype.name == "string":
        out = np.array([None if v is None else str(v) for v in col],
                       dtype=object)
        if nmask is not None:
            out[nmask] = None
        return out, (np.asarray(nmask) if nmask is not None else None)
    arr = np.asarray(col)
    obj_nulls = None
    if arr.dtype == object:
        obj_nulls = np.array([v is None for v in arr])
        arr = np.array([0 if v is None else v for v in arr])
    combined = nmask
    if obj_nulls is not None and obj_nulls.any():
        combined = obj_nulls if combined is None else (combined | obj_nulls)
    return arr.astype(dtype.np_dtype), \
        (np.asarray(combined) if combined is not None else None)


def _contains_subquery(plan: ast.Plan) -> bool:
    found = [False]

    def fn(e: ast.Expr) -> ast.Expr:
        if isinstance(e, (ast.ScalarSubquery, ast.InSubquery,
                          ast.ExistsSubquery)):
            found[0] = True
        return e

    ast.transform_plan_exprs(plan, fn)
    return found[0]
