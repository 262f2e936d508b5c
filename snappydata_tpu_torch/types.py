"""Data type system.

Port of snappydata_tpu/types.py.  Covers the SQL surface the reference
supports for column/row tables (ref: SnappyDDLParser column data types;
encoders/.../encoding/ColumnEncoding.scala typeId registry :766-774).
Every type lowers to a fixed-width device dtype; variable-width types
(STRING/DECIMAL) lower to dictionary codes / scaled integers.
`device_dtype` returns numpy dtypes, as in the reference; `torch_dtype`
maps them onto torch dtypes for the device plates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataType:
    name: str

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.name

    @property
    def np_dtype(self) -> np.dtype:
        if self.name in ("array", "map", "struct"):
            return np.dtype(object)
        return _NP[self.name]

    def device_dtype(self) -> np.dtype:
        """dtype of the decoded on-device representation."""
        from snappydata_tpu_torch import config

        if self.name == "string":
            return np.dtype(np.int32)  # dictionary codes
        if self.name == "decimal":
            if getattr(self, "is_exact", False):
                return np.dtype(np.int64)  # scaled unscaled-value ints
            return np.dtype(np.float64 if config.use_float64() else np.float32)
        if self.name in ("double", "float") and not config.use_float64():
            return np.dtype(np.float32)
        return self.np_dtype


@dataclasses.dataclass(frozen=True)
class ArrayType(DataType):
    """ARRAY<T>: stored as python lists (host); queries referencing array
    columns evaluate on the host path (device arrays are a later round)."""

    element: "DataType" = None

    def __str__(self):
        return f"array<{self.element}>"


@dataclasses.dataclass(frozen=True)
class MapType(DataType):
    """MAP<K,V>: python dicts, host-evaluated like ARRAY."""

    key: "DataType" = None
    value: "DataType" = None

    def __str__(self):
        return f"map<{self.key},{self.value}>"


@dataclasses.dataclass(frozen=True)
class StructType(DataType):
    """STRUCT<name: type, ...>: python dicts keyed by field name (host
    values); field access via element_at(col, 'name') / named_struct
    literals (ref: SerializedRow complex values,
    encoders/.../catalyst/util/SerializedRow.scala)."""

    fields: tuple = ()   # Tuple[Tuple[str, DataType], ...]

    def __str__(self):
        inner = ", ".join(f"{n}: {t}" for n, t in self.fields)
        return f"struct<{inner}>"

    def field_type(self, name: str) -> Optional["DataType"]:
        for n, t in self.fields:
            if n.lower() == name.lower():
                return t
        return None


@dataclasses.dataclass(frozen=True)
class DecimalType(DataType):
    """DECIMAL(p, s). TPU-first physical mapping (ref: exact BigDecimal
    semantics, encoders/.../encoding/ColumnEncoding.scala:137-140
    readDecimal):

    - p <= 18 ("exact"): DEVICE representation is the scaled int64
      unscaled value (v * 10^s) — SUM/MIN/MAX/COUNT/GROUP BY and
      +,-,*,% / comparisons run as fast native integer ops and stay
      EXACT; results decode to decimal.Decimal at the client edge. The
      HOST mirror (plates, WAL, deltas, hosteval fallback, and
      cross-server partial aggregates re-entering the distributed
      merge) stays float64, which round-trips any
      <= 15-significant-digit decimal exactly — so end-to-end
      exactness holds through p=15 (per-shard partials included) and
      device aggregation exactness through p=18.
    - p > 18: lowers to the float path (f32 plates on TPU with f64
      accumulators, <= 1e-6 relative — the pre-round-5 behavior).
    """

    precision: int = 38
    scale: int = 2

    def __str__(self) -> str:  # pragma: no cover - trivial
        return f"decimal({self.precision},{self.scale})"

    @property
    def is_exact(self) -> bool:
        from snappydata_tpu_torch import config

        return (self.precision <= 18
                and config.global_properties().decimal_exact)

    @property
    def scale_factor(self) -> int:
        return 10 ** self.scale


BOOLEAN = DataType("boolean")
BYTE = DataType("byte")
SHORT = DataType("short")
INT = DataType("int")
LONG = DataType("long")
FLOAT = DataType("float")
DOUBLE = DataType("double")
STRING = DataType("string")
DATE = DataType("date")          # int32 days since epoch
TIMESTAMP = DataType("timestamp")  # int64 microseconds since epoch
DECIMAL = DecimalType("decimal")

_NP = {
    "boolean": np.dtype(np.bool_),
    "byte": np.dtype(np.int8),
    "short": np.dtype(np.int16),
    "int": np.dtype(np.int32),
    "long": np.dtype(np.int64),
    "float": np.dtype(np.float32),
    "double": np.dtype(np.float64),
    "string": np.dtype(object),
    "date": np.dtype(np.int32),
    "timestamp": np.dtype(np.int64),
    "decimal": np.dtype(np.float64),
}

_BY_NAME = {
    "boolean": BOOLEAN, "bool": BOOLEAN,
    "byte": BYTE, "tinyint": BYTE,
    "short": SHORT, "smallint": SHORT,
    "int": INT, "integer": INT,
    "long": LONG, "bigint": LONG,
    "float": FLOAT, "real": FLOAT,
    "double": DOUBLE,
    "string": STRING, "varchar": STRING, "char": STRING, "clob": STRING,
    "date": DATE,
    "timestamp": TIMESTAMP,
    "decimal": DECIMAL, "numeric": DECIMAL,
}


def parse_type(name: str, args: Optional[list] = None,
               element: Optional[DataType] = None,
               key: Optional[DataType] = None,
               fields: Optional[list] = None) -> DataType:
    if name.lower() == "array":
        return ArrayType("array", element or DOUBLE)
    if name.lower() == "map":
        return MapType("map", key or STRING, element or DOUBLE)
    if name.lower() == "struct":
        return StructType("struct", tuple(fields or ()))
    base = _BY_NAME.get(name.lower())
    if base is None:
        raise ValueError(f"unknown data type: {name}")
    if base.name == "decimal" and args:
        prec = int(args[0])
        scale = int(args[1]) if len(args) > 1 else 0
        return DecimalType("decimal", prec, scale)
    return base


def torch_dtype(np_dtype):
    """numpy dtype -> the torch dtype of a device plate."""
    import torch

    return {
        np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
        np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
        np.dtype(np.uint16): torch.uint16, np.dtype(np.int32): torch.int32,
        np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
        np.dtype(np.float64): torch.float64,
    }[np.dtype(np_dtype)]


def is_numeric(dt: DataType) -> bool:
    return dt.name in ("byte", "short", "int", "long", "float", "double",
                       "decimal", "date", "timestamp")


def is_integral(dt: DataType) -> bool:
    return dt.name in ("byte", "short", "int", "long", "date", "timestamp")


def is_floating(dt: DataType) -> bool:
    return dt.name in ("float", "double", "decimal")


def common_type(a: DataType, b: DataType) -> DataType:
    """Numeric type promotion for binary expressions."""
    if a.name == b.name:
        if a.name == "decimal" and a != b:
            return _decimal_align_type(a, b)
        return a
    if "decimal" in (a.name, b.name):
        dec, other = (a, b) if a.name == "decimal" else (b, a)
        if other.name in ("float", "double"):
            return DOUBLE
        if other.name in _INT_DIGITS:
            return _decimal_align_type(dec, _int_as_decimal(other))
        if other.name == "string":
            return STRING
        return DOUBLE
    order = ["boolean", "byte", "short", "int", "date", "long", "timestamp",
             "float", "decimal", "double"]
    if a.name in order and b.name in order:
        return _BY_NAME[max(a.name, b.name, key=order.index)]
    if STRING in (a, b):
        return STRING
    raise TypeError(f"incompatible types: {a} vs {b}")


# ---------------------------------------------------------------------------
# Exact-decimal type algebra (shared by the analyzer's expr_type and the
# runtime's scaled-int lowering so declared scale always matches the
# computed representation). Result precision/scale follow Spark's
# DecimalPrecision rules, capped: a result that would exceed precision
# 18 lowers to DOUBLE instead (int64 can't hold it; the reference holds
# p <= 38 via BigDecimal — documented divergence).
# ---------------------------------------------------------------------------

DECIMAL_EXACT_MAX_PRECISION = 18

_INT_DIGITS = {"boolean": 1, "byte": 3, "short": 5, "int": 10, "long": 19}


def _int_as_decimal(t: DataType) -> "DecimalType":
    return DecimalType("decimal", _INT_DIGITS[t.name], 0)


def _decimal_align_type(a: "DecimalType", b: "DecimalType") -> DataType:
    s = max(a.scale, b.scale)
    p = max(a.precision - a.scale, b.precision - b.scale) + s
    if p > DECIMAL_EXACT_MAX_PRECISION:
        return DOUBLE
    return DecimalType("decimal", p, s)


def decimal_binop_type(op: str, a: DataType, b: DataType
                       ) -> Optional[DataType]:
    """Result type of a +,-,*,%,/ over operands where at least one side
    is decimal. None = not a decimal-typed operation (caller falls back
    to common_type). DOUBLE = the operation leaves the exact domain."""
    if "decimal" not in (a.name, b.name):
        return None
    if op == "/":
        return DOUBLE
    for t in (a, b):
        if t.name in ("float", "double") or (
                t.name not in _INT_DIGITS and t.name != "decimal"):
            return DOUBLE
    da = a if a.name == "decimal" else _int_as_decimal(a)
    db = b if b.name == "decimal" else _int_as_decimal(b)
    if op == "*":
        p = da.precision + db.precision + 1
        s = da.scale + db.scale
        if p > DECIMAL_EXACT_MAX_PRECISION or not (
                isinstance(da, DecimalType) and da.is_exact
                and isinstance(db, DecimalType) and db.is_exact):
            return DOUBLE
        return DecimalType("decimal", p, s)
    if op in ("+", "-", "%"):
        s = max(da.scale, db.scale)
        p = max(da.precision - da.scale, db.precision - db.scale) + s + 1
        if p > DECIMAL_EXACT_MAX_PRECISION:
            return DOUBLE
        return DecimalType("decimal", p, s)
    return None


def decimal_sum_type(dt: DataType) -> DataType:
    """SUM over a decimal column: widen precision (Spark: p+10), capped
    at the exact-int64 limit — the in-trace overflow check reroutes to
    the host path if a group total could actually exceed int64."""
    if not isinstance(dt, DecimalType) or not dt.is_exact:
        return DOUBLE
    return DecimalType("decimal",
                       min(dt.precision + 10, DECIMAL_EXACT_MAX_PRECISION),
                       dt.scale)


def decimal_to_unscaled(dt: DataType, arr) -> np.ndarray:
    """Host-domain (float) decimal values -> scaled int64 unscaled
    values, rounding half away from zero at the column scale (HALF_UP,
    matching _dec_rescale_int and java BigDecimal — np.round would tie
    to even and disagree with the device rescale path)."""
    a = np.asarray(arr, dtype=np.float64) * float(dt.scale_factor)
    return (np.sign(a) * np.floor(np.abs(a) + 0.5)).astype(np.int64)


def unscaled_to_python(dt: DataType, v: int):
    """Scaled int64 -> decimal.Decimal at the column scale."""
    import decimal as _d

    return _d.Decimal(int(v)).scaleb(-dt.scale)


def decimal_float_converter(dt: DataType):
    """Column-level converter: float-domain decimal value ->
    decimal.Decimal quantized at the column scale, with the quantizer
    hoisted once (per-cell construction was measurable on streamed
    exports). Exact whenever the f64 faithfully represents the decimal,
    i.e. <= 15 significant digits."""
    import decimal as _d

    q = _d.Decimal(1).scaleb(-dt.scale)

    def conv(v):
        return _d.Decimal(repr(float(v))).quantize(
            q, rounding=_d.ROUND_HALF_UP)

    return conv


def float_to_python_decimal(dt: DataType, v: float):
    """One-off variant of decimal_float_converter."""
    return decimal_float_converter(dt)(v)


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def names(self):
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        name_l = name.lower()
        for f in self.fields:
            if f.name.lower() == name_l:
                return f
        raise KeyError(f"no such column: {name}")

    def index(self, name: str) -> int:
        name_l = name.lower()
        for i, f in enumerate(self.fields):
            if f.name.lower() == name_l:
                return i
        raise KeyError(f"no such column: {name}")

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)


def python_value(dt: DataType, v: Any) -> Any:
    """Coerce a parsed literal to the column's python/numpy domain."""
    if v is None:
        return None
    if dt.name in ("byte", "short", "int", "long", "date", "timestamp"):
        return int(v)
    if dt.name in ("float", "double", "decimal"):
        return float(v)
    if dt.name == "boolean":
        return bool(v)
    return str(v)
