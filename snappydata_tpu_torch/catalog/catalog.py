"""Catalog: table/view metadata + storage handles.

Fills the role of SnappySessionCatalog / SnappyHiveExternalCatalog
(core/.../internal/SnappySessionCatalog.scala, hive/
SnappyHiveExternalCatalog.scala:68) minus the Hive client: metadata lives
in-process and persists as JSON next to the table data (the reference
persists its metastore inside its own row store; our durable layer does the
analogue when persistence lands).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.storage.table_store import (ColumnTableData,
                                                     RowTableData)
from snappydata_tpu_torch.utils import locks


@dataclasses.dataclass
class TableInfo:
    name: str                       # normalized (lower) fully-qualified
    schema: T.Schema
    provider: str                   # column | row | sample
    options: Dict[str, str]
    data: object                    # ColumnTableData | RowTableData
    key_columns: tuple = ()
    partition_by: tuple = ()        # PARTITION_BY columns (bucket placement)
    buckets: int = 0                # 0 = replicated
    colocate_with: Optional[str] = None
    redundancy: int = 0
    base_table: Optional[str] = None   # sample tables: the base they sample
    sample_options: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def is_row(self) -> bool:
        return self.provider == "row"


def _norm(name: str) -> str:
    return name.lower().removeprefix("app.")


class Catalog:
    def __init__(self):
        self._lock = locks.named_lock("catalog.state")
        self._tables: Dict[str, TableInfo] = {}
        self._views: Dict[str, object] = {}   # name -> logical plan
        # bumped on every DDL so compiled-plan caches keyed on it can't
        # serve a dropped/recreated table's pinned storage (review finding)
        self.generation = 0

    # --- DDL -------------------------------------------------------------

    def create_table(self, name: str, schema: T.Schema, provider: str,
                     options: Dict[str, str], if_not_exists: bool = False,
                     key_columns: Sequence[str] = ()) -> TableInfo:
        from snappydata_tpu_torch import config

        props = config.global_properties()
        key = _norm(name)
        with self._lock:
            if key in self._tables:
                if if_not_exists:
                    return self._tables[key]
                raise ValueError(f"table already exists: {name}")
            opts = {k.lower(): str(v) for k, v in options.items()}
            partition_by = tuple(
                c.strip().lower()
                for c in opts.get("partition_by", "").split(",") if c.strip())
            buckets = int(opts.get("buckets", props.num_buckets
                                   if partition_by else 0))
            provider = provider.lower()
            key_columns = tuple(k.lower() for k in key_columns) or tuple(
                c.strip().lower() for c in opts.get("key_columns", "").split(",")
                if c.strip())
            if provider == "row":
                data = RowTableData(schema, key_columns=key_columns)
            else:
                cap = int(opts.get("column_batch_rows",
                                   props.column_batch_rows))
                max_delta = int(opts.get("column_max_delta_rows",
                                         props.column_max_delta_rows))
                data = ColumnTableData(schema, capacity=cap,
                                       max_delta_rows=max_delta)
                if "eviction_bytes" in opts:
                    # the per-table EVICTION clause analogue: this table
                    # spills above its own host budget
                    data.eviction_bytes = int(opts["eviction_bytes"])
            base_table = opts.get("basetable") or opts.get("base_table")
            info = TableInfo(
                name=key, schema=schema, provider=provider, options=opts,
                data=data, key_columns=key_columns, partition_by=partition_by,
                buckets=buckets,
                colocate_with=_norm(opts["colocate_with"])
                if "colocate_with" in opts else None,
                redundancy=int(opts.get("redundancy", 0)),
                base_table=_norm(base_table) if base_table else None)
            self._tables[key] = info
            self.generation += 1
        # the resource broker's ledger, keyed per catalog (same-named
        # tables of two catalogs must not clobber each other); internal
        # '__'-named scratch tables (the tiled merge's partials) stay out.
        # Outside the catalog lock: the broker has its own
        if not key.split(".")[-1].startswith("__"):
            from snappydata_tpu_torch.resource import global_broker

            global_broker().register_table(key, data, owner=id(self))
        return info

    def drop_table(self, name: str, if_exists: bool = False) -> bool:
        key = _norm(name)
        with self._lock:
            if key not in self._tables:
                if if_exists:
                    return False
                raise ValueError(f"table not found: {name}")
            del self._tables[key]
            self.generation += 1
        # a plan cache may keep the data object alive: a dropped table
        # must stop counting toward broker memory pressure
        from snappydata_tpu_torch.resource import global_broker

        global_broker().unregister_table(key, owner=id(self))
        return True

    def create_view(self, name: str, plan, or_replace: bool = False) -> None:
        key = _norm(name)
        with self._lock:
            if key in self._views and not or_replace:
                raise ValueError(f"view already exists: {name}")
            self._views[key] = plan
            self.generation += 1

    def drop_view(self, name: str, if_exists: bool = False) -> bool:
        key = _norm(name)
        with self._lock:
            if key not in self._views:
                if if_exists:
                    return False
                raise ValueError(f"view not found: {name}")
            del self._views[key]
            self.generation += 1
            return True

    # --- lookup (analyzer interface) -------------------------------------

    def lookup_table(self, name: str) -> Optional[TableInfo]:
        return self._tables.get(_norm(name))

    def lookup_view(self, name: str):
        return self._views.get(_norm(name))

    def list_tables(self) -> List[TableInfo]:
        return sorted(self._tables.values(), key=lambda t: t.name)

    def describe(self, name: str) -> TableInfo:
        info = self.lookup_table(name)
        if info is None:
            raise ValueError(f"table not found: {name}")
        return info
