"""Column encodings: PLAIN / DICTIONARY / RUN_LENGTH / BOOLEAN_BITSET.

Behavioral contract follows the reference decoder registry
(encoders/.../encoding/ColumnEncoding.scala:766-774 — Uncompressed,
RunLength, Dictionary, BigDictionary, BooleanBitSet) and the per-batch
stats row (ColumnStatsSchema: min/max/nullCount per column used for
predicate batch-skipping in ColumnTableScan filter codegen).

TPU-first physical design: the encoded form lives on host as numpy; decode
targets a fixed `capacity`-row device plate so XLA compiles one kernel per
table shape. `decode_to_numpy` here is the host decode path (mutation
predicates, mesh binds, delta-bearing batches); cold single-device binds
of RLE/bitset batches instead ship the encoded arrays and expand in-trace
(`storage/device_decode.py`), so compressed bytes — not decoded plates —
cross the host→device link. Strings never reach the device: they stay
dictionary codes (int32) with the dictionary host-side —
group-by/join on strings runs on codes, mirroring the reference's
dictionary fast path (DictionaryOptimizedMapAccessor).
"""

from __future__ import annotations

import dataclasses
import enum
import zlib
from typing import Any, Optional, Tuple

import numpy as np

from snappydata_tpu_torch import types as T


class Encoding(enum.IntEnum):
    PLAIN = 0
    DICTIONARY = 1
    RUN_LENGTH = 2
    BOOLEAN_BITSET = 3
    OBJECT = 4  # raw python objects (ARRAY columns; host-evaluated)
    # low-cardinality NUMERIC columns: uint8 (≤256 distinct) or uint16
    # (≤64K distinct, 8-byte values only — codes stay 4× smaller) codes
    # into a SORTED value dictionary (ref IntDictionary/BigDictionary
    # typeIds) — device binds ship the codes + tiny dictionary and
    # either gather in-trace (device_decode.valdict_views_to_plate) or
    # stay resident as a code plate under compressed-domain execution
    # (device_decode.CodePlate), where predicates compare codes against
    # literals translated through the sorted dictionary
    VALUE_DICT = 5


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-batch column stats (ref stats row, meta column index -1)."""

    min: Any
    max: Any
    null_count: int
    count: int

    @staticmethod
    def of(values: np.ndarray, validity: Optional[np.ndarray]) -> "ColumnStats":
        if validity is not None:
            valid = values[validity]
            nulls = int(values.shape[0] - valid.shape[0])
        else:
            valid = values
            nulls = 0
        if valid.size == 0:
            return ColumnStats(None, None, nulls, int(values.shape[0]))
        if valid.dtype == object:
            if valid.shape[0] > 1024:
                import pandas as pd

                s = pd.Series(valid, dtype=object).dropna()
                nulls += int(valid.shape[0] - s.shape[0])
                if s.empty:
                    return ColumnStats(None, None, nulls,
                                       int(values.shape[0]))
                lo, hi = s.min(), s.max()
                return ColumnStats(lo, hi, nulls, int(values.shape[0]))
            non_null = [v for v in valid.tolist() if v is not None]
            nulls += len(valid) - len(non_null)
            if not non_null:
                return ColumnStats(None, None, nulls, int(values.shape[0]))
            lo, hi = min(non_null), max(non_null)
        else:
            lo, hi = valid.min(), valid.max()
            lo = lo.item() if hasattr(lo, "item") else lo
            hi = hi.item() if hasattr(hi, "item") else hi
        return ColumnStats(lo, hi, nulls, int(values.shape[0]))


@dataclasses.dataclass(frozen=True)
class EncodedColumn:
    """Host-resident encoded column of one batch. Immutable."""

    encoding: Encoding
    dtype: T.DataType
    num_rows: int
    # PLAIN: data = values (device dtype); DICTIONARY: data = int32 codes
    # RUN_LENGTH: data = run values, runs = int32 run lengths
    # BOOLEAN_BITSET: data = packed uint8 bits
    data: np.ndarray
    dictionary: Optional[np.ndarray] = None   # DICTIONARY only (host values)
    runs: Optional[np.ndarray] = None         # RUN_LENGTH only
    validity: Optional[np.ndarray] = None     # packed uint8 bits; None = no nulls
    stats: Optional[ColumnStats] = None

    @property
    def nbytes(self) -> int:
        n = self.data.nbytes if self.data.dtype != object else self.data.size * 16
        for a in (self.dictionary, self.runs, self.validity):
            if a is not None and a.dtype != object:
                n += a.nbytes
        return n


def _device_np_dtype(dtype: T.DataType) -> np.dtype:
    if dtype.name == "decimal":
        # at-rest decimal bytes stay in the HOST (plain float64) domain:
        # the exact path's scaled-int64 form is produced at device bind
        # (types.DecimalType docstring) — encoding at device_dtype here
        # would TRUNCATE values through the int64 cast
        return dtype.np_dtype
    return dtype.device_dtype()


def encode_column(values: np.ndarray, dtype: T.DataType,
                  validity: Optional[np.ndarray] = None,
                  dictionary_hint: Optional[np.ndarray] = None) -> EncodedColumn:
    """Pick an encoding the way the reference's ColumnEncoder typeId
    selection does: strings always dictionary; low-cardinality fixed-width →
    RLE when it actually shrinks; booleans → bitset; else plain.

    `dictionary_hint` forces a shared (table-level) dictionary so codes are
    comparable across batches without re-mapping — the property the
    reference gets from its per-batch dictionaries plus codegen string
    compare, and that we need globally for device-side group-by on codes.
    """
    n = int(values.shape[0])
    if dtype.name in ("array", "map"):
        # raw object storage; queries over complex columns run host-side
        obj = np.asarray(values, dtype=object)
        nulls_mask = np.fromiter((v is None for v in obj), dtype=np.bool_,
                                 count=n)
        packed = None
        if validity is not None:
            nulls_mask |= ~np.asarray(validity)
        if nulls_mask.any():
            from snappydata_tpu_torch.storage import bitmask

            packed = bitmask.pack(~nulls_mask)
        return EncodedColumn(Encoding.OBJECT, dtype, n, obj,
                             validity=packed,
                             stats=ColumnStats(None, None,
                                               int(nulls_mask.sum()), n))
    if dtype.name == "string" and validity is None:
        # derive validity from SQL NULL (None) values (vectorized)
        nulls = np.asarray(values) == None  # noqa: E711 elementwise
        if nulls.any():
            validity = ~nulls
    packed_validity = None
    if validity is not None and not validity.all():
        from snappydata_tpu_torch.storage import bitmask

        packed_validity = bitmask.pack(validity)
    else:
        validity = None
    if dtype.name in ("string", "array", "map", "struct"):
        # no min/max for strings (predicates run through dictionary LUTs)
        # or complex values (dicts aren't even orderable) — stats-based
        # batch skipping never applies to them
        nulls = int((~validity).sum()) if validity is not None else 0
        stats = ColumnStats(None, None, nulls, n)
    else:
        stats = ColumnStats.of(values, validity)

    if dtype.name == "string":
        if dictionary_hint is not None:
            dictionary = dictionary_hint
            if n > 1024:
                # vectorized code assignment (C-side hash join)
                import pandas as pd

                obj = np.asarray(values, dtype=object)
                codes = pd.Categorical(
                    obj, categories=dictionary).codes.astype(np.int32)
                missing = codes < 0
                if missing.any():
                    # only NULLs may be absent from the hint; a real value
                    # missing means a broken interning invariant — fail
                    # loudly like the small-batch path (review finding)
                    bad = missing & ~pd.isna(obj)
                    if bad.any():
                        raise KeyError(
                            f"value not in dictionary hint: "
                            f"{obj[bad][:3].tolist()}")
                    codes = np.where(missing, 0, codes)
            else:
                lookup = {v: i for i, v in enumerate(dictionary.tolist())}
                codes = np.fromiter(
                    (lookup[v] if v is not None else 0 for v in values),
                    dtype=np.int32, count=n)
        else:
            vals_list = values.tolist()
            filler = next((v for v in vals_list if v is not None), "")
            cleaned = np.array([filler if v is None else v for v in vals_list],
                               dtype=object)
            dictionary, codes = np.unique(cleaned, return_inverse=True)
            codes = codes.astype(np.int32)
        return EncodedColumn(Encoding.DICTIONARY, dtype, n, codes,
                             dictionary=dictionary, validity=packed_validity,
                             stats=stats)

    if dtype.name == "boolean":
        from snappydata_tpu_torch.storage import bitmask

        return EncodedColumn(Encoding.BOOLEAN_BITSET, dtype, n,
                             bitmask.pack(values.astype(np.bool_)),
                             validity=packed_validity, stats=stats)

    dev = values.astype(_device_np_dtype(dtype), copy=False)
    # RLE probe: cheap run-length count; accept if ≥4x shrink (ref
    # RunLengthEncoding targets low-cardinality columns).
    if n > 64:
        changes = np.flatnonzero(dev[1:] != dev[:-1])
        num_runs = changes.size + 1
        if num_runs * 2 <= n // 4:
            starts = np.concatenate(([0], changes + 1))
            ends = np.concatenate((changes + 1, [n]))
            return EncodedColumn(
                Encoding.RUN_LENGTH, dtype, n, dev[starts].copy(),
                runs=(ends - starts).astype(np.int32),
                validity=packed_validity, stats=stats)
        vd = _try_value_dict(dev, dtype, n, packed_validity, stats)
        if vd is not None:
            return vd
    return EncodedColumn(Encoding.PLAIN, dtype, n, np.ascontiguousarray(dev),
                         validity=packed_validity, stats=stats)


# value-dict acceptance: codes must stay ≥4x smaller than the values
# they replace — uint8 codes for any ≥4-byte value (≤256 distinct), and
# uint16 codes (≤64K distinct) only for 8-byte values (f64/i64: 2-byte
# codes keep the 4x shrink).  A SAMPLE probe rejects high-cardinality
# columns in O(sample) so the ingest hot lane never pays a full-column
# unique for columns that won't encode.
_VALUE_DICT_MAX_U8 = 256
_VALUE_DICT_MAX = 1 << 16
_VALUE_DICT_SAMPLE = 4096


def _value_dict_cap(itemsize: int) -> int:
    """Distinct-value ceiling keeping the ≥4x code shrink."""
    return _VALUE_DICT_MAX if itemsize >= 8 else _VALUE_DICT_MAX_U8


def _value_dict_code_dtype(num_distinct: int) -> np.dtype:
    return np.dtype(np.uint8 if num_distinct <= _VALUE_DICT_MAX_U8
                    else np.uint16)


def _try_value_dict(dev: np.ndarray, dtype: T.DataType, n: int,
                    packed_validity, stats) -> Optional["EncodedColumn"]:
    if dev.dtype.itemsize < 4 or dev.dtype.kind not in "iuf":
        return None   # sub-4-byte values wouldn't shrink 4x
    cap = _value_dict_cap(dev.dtype.itemsize)
    sample = dev[::max(1, n // _VALUE_DICT_SAMPLE)]
    cand = np.unique(sample)
    # the dictionary must be SMALL relative to the rows (n ≥ 8·D) or the
    # dict bytes eat the shrink; the sample's distinct count is a lower
    # bound on D, so this also rejects early
    if cand.size > cap or n < 8 * cand.size:
        return None
    if dev.dtype.kind == "f" and np.isnan(cand).any():
        return None   # NaN breaks searchsorted code assignment
    # code against the sample dictionary, then repair the (rare) values
    # the sample missed — for a truly low-cardinality column the repair
    # set is tiny, so total cost stays O(n log D)
    for _ in range(2):
        codes = np.searchsorted(cand, dev)
        codes_c = np.minimum(codes, cand.size - 1)
        missed = cand[codes_c] != dev
        if not missed.any():
            return EncodedColumn(
                Encoding.VALUE_DICT, dtype, n,
                codes_c.astype(_value_dict_code_dtype(cand.size)),
                dictionary=cand,
                validity=packed_validity, stats=stats)
        extra = np.unique(dev[missed])
        if dev.dtype.kind == "f" and np.isnan(extra).any():
            return None
        cand = np.union1d(cand, extra)
        if cand.size > cap or n < 8 * cand.size:
            return None
    return None   # pragma: no cover - two passes always converge


def decode_to_numpy(col: EncodedColumn, capacity: Optional[int] = None,
                    strings: bool = False) -> np.ndarray:
    """Decode to a host array padded to `capacity` rows (device dtype).

    With strings=True a DICTIONARY string column decodes to the actual
    object values (host-side paths: mutation predicates, result assembly);
    otherwise it yields int32 codes, the on-device representation.
    """
    n = col.num_rows
    cap = capacity if capacity is not None else n
    if col.encoding == Encoding.PLAIN:
        out = col.data
    elif col.encoding == Encoding.DICTIONARY:
        out = col.dictionary[col.data] if strings else col.data
    elif col.encoding == Encoding.VALUE_DICT:
        out = col.dictionary[col.data]
    elif col.encoding == Encoding.RUN_LENGTH:
        out = np.repeat(col.data, col.runs)
    elif col.encoding == Encoding.OBJECT:
        out = col.data
    elif col.encoding == Encoding.BOOLEAN_BITSET:
        from snappydata_tpu_torch.storage import bitmask

        out = bitmask.unpack(col.data, n)
    else:  # pragma: no cover
        raise ValueError(f"unknown encoding {col.encoding}")
    if cap > n:
        if out.dtype == object:
            pad = np.full(cap - n, None, dtype=object)
        else:
            pad = np.zeros(cap - n, dtype=out.dtype)
        out = np.concatenate([out, pad])
    return out


def decode_validity(col: EncodedColumn, capacity: Optional[int] = None) -> Optional[np.ndarray]:
    if col.validity is None:
        return None
    from snappydata_tpu_torch.storage import bitmask

    v = bitmask.unpack(col.validity, col.num_rows)
    cap = capacity if capacity is not None else col.num_rows
    if cap > col.num_rows:
        v = np.concatenate([v, np.zeros(cap - col.num_rows, dtype=np.bool_)])
    return v


# --- at-rest compression (ref: CompressionUtils LZ4/Snappy; env has zlib) ---

_zstd_available: Optional[bool] = None


def _have_zstd() -> bool:
    global _zstd_available
    if _zstd_available is None:
        try:
            import zstandard  # noqa: F401

            _zstd_available = True
        except ImportError:
            _zstd_available = False
    return _zstd_available


def compress_bytes(raw: bytes, codec: str) -> Tuple[str, bytes]:
    if codec == "zstd":
        if _have_zstd():
            import zstandard

            return "zstd", zstandard.ZstdCompressor(level=1).compress(raw)
        # zstandard not installed: degrade to the stdlib codec instead of
        # failing every WAL append / checkpoint on this machine (each
        # record tags the codec actually used, so mixed files read fine)
        codec = "zlib"
    if codec == "zlib":
        return "zlib", zlib.compress(raw, level=1)
    return "none", raw


def decompress_bytes(codec: str, blob: bytes) -> bytes:
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    return blob
