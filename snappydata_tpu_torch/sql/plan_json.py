"""Logical-plan wire format: AST ⇄ JSON (port of
snappydata_tpu/sql/plan_json.py; either package decodes the other's).

Plan-fragment shipping for distributed execution (ref: the lead ships
Catalyst plans to real executors, SparkSQLExecuteImpl.scala:75-109):
instead of re-rendering a rewritten plan to SQL text — which leaks
shapes the single-block renderer can't express (GROUPING SETS, window
partials, decorrelated semi/anti FROM trees) — the lead serializes the
UNRESOLVED logical plan and each server deserializes and executes it
through its normal session pipeline (analyze → optimize → compile).

Serialization is generic over the ast/types dataclasses: a node encodes
as {"_t": "ClassName", ...fields...}; sequences round-trip as tuples
(every ast child container is a tuple), dates/np-scalars get tagged
encodings. Only classes registered in `snappydata_tpu_torch.sql.ast` /
`snappydata_tpu_torch.types` deserialize — arbitrary type names are rejected
(the Flight surface is authenticated, but the decoder still refuses to
instantiate anything outside the AST namespace).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import numpy as np

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.sql import ast


class PlanCodecError(ValueError):
    pass


def to_json(obj: Any):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, datetime.datetime):
        return {"_ts": obj.isoformat()}
    if isinstance(obj, datetime.date):
        return {"_d": obj.isoformat()}
    if isinstance(obj, (list, tuple)):
        return {"_seq": [to_json(v) for v in obj]}
    if dataclasses.is_dataclass(obj):
        cls = type(obj).__name__
        out = {"_t": cls}
        for f in dataclasses.fields(obj):
            out[f.name] = to_json(getattr(obj, f.name))
        return out
    raise PlanCodecError(f"cannot serialize {type(obj).__name__}")


def _resolve_class(name: str):
    cls = getattr(ast, name, None)
    if cls is None:
        cls = getattr(T, name, None)
    if cls is None or not (dataclasses.is_dataclass(cls)
                           or cls is T.Schema):
        raise PlanCodecError(f"unknown plan node type {name!r}")
    return cls


def from_json(obj: Any):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):  # bare list (shouldn't occur, but accept)
        return tuple(from_json(v) for v in obj)
    if isinstance(obj, dict):
        if "_seq" in obj:
            return tuple(from_json(v) for v in obj["_seq"])
        if "_d" in obj:
            return datetime.date.fromisoformat(obj["_d"])
        if "_ts" in obj:
            return datetime.datetime.fromisoformat(obj["_ts"])
        if "_t" in obj:
            cls = _resolve_class(obj["_t"])
            if cls is T.Schema:
                return T.Schema(from_json(obj["fields"]))
            kwargs = {k: from_json(v) for k, v in obj.items()
                      if k != "_t"}
            return cls(**kwargs)
    raise PlanCodecError(f"cannot deserialize {obj!r}")
