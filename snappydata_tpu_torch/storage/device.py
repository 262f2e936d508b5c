"""Manifest -> stacked device plates (the input side of every compiled plan).

Port of snappydata_tpu/storage/device.py cut to the column-table bind: a
table snapshot is materialized as ONE [num_batches, capacity] tensor per
referenced column on the session's torch device, plus a shared validity
plate (row count and delete masks already applied).  The batch count is
padded on the {2^k, 1.5*2^k} ladder, as in the reference, so plate shapes
stay stable as a table grows.

Under `scan_compressed_domain` a column whose batches all share one
compressible encoding stays resident in it (storage/device_decode):
VALUE_DICT as a `CodePlate`, RUN_LENGTH as an `RlePlate`, BOOLEAN_BITSET
as a `BitPlate`; every other column binds decoded, and each reroute of a
compressible column is counted as `compressed_fallback_<reason>`.

Exact decimals (DECIMAL(p<=18)) keep float64 host plates, the SQL value
domain, and bind as the scaled int64 unscaled value `round(v * 10^s)`
(HALF_UP), as in the reference; they never stay code-resident.

Update deltas and delete masks (storage/table_store.BatchView) apply at
the bind: a column with a delta decodes with it merged (its encoded form
is refused, counted `compressed_fallback_deltas`), deletes ride the
validity plate.  The bind reads the statement's pinned manifest
(storage/mvcc), and the plate cache keeps every pinned version.

Per-batch min/max stats ride along host-side for predicate batch
skipping (ref: stats-row filter codegen, columnBatchesSkipped metric,
ColumnTableScan.scala:115-130).  Plates are cached per (manifest
version, device, scan window).

Tiled scans bind a WINDOW of the table's scan units (column batches,
then row-buffer chunks of `capacity` rows): `scan_window` restricts
`build_device_table` to units [lo, hi) of a pinned manifest, and the
host fallback reads the same units through `host_scan_units`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.storage import bitmask
from snappydata_tpu_torch.storage import device_decode as _dd
from snappydata_tpu_torch.storage import mvcc
from snappydata_tpu_torch.storage.encoding import Encoding
from snappydata_tpu_torch.storage.table_store import ColumnTableData


def batch_bucket(n: int) -> int:
    """Padded BATCH-axis size: the smallest of {2^k, 1.5 * 2^k} >= n."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    return p * 3 // 4 if p * 3 // 4 >= n else p


# --- tiled scans: bind a WINDOW of the batch axis ------------------------
# For tables whose decoded columns exceed the device budget, the session
# streams scan units through the same compiled program tile by tile.

_scan_windows: contextvars.ContextVar = contextvars.ContextVar(
    "scan_windows", default=None)


@contextlib.contextmanager
def scan_window(data, lo: int, hi: int, manifest=None, tile_units=None):
    """Restrict build_device_table (and host_scan_units) for `data` to
    units [lo, hi).  `manifest` pins one snapshot across a multi-tile
    pass, so a mutation between tiles cannot mix table versions.
    `tile_units` is the pass's NOMINAL window width: the last window may
    be truncated, and current_scan_scale needs the nominal width to
    compute the true tile count."""
    cur = dict(_scan_windows.get() or {})
    cur[id(data)] = (int(lo), int(hi), manifest,
                     int(tile_units) if tile_units else int(hi - lo))
    tok = _scan_windows.set(cur)
    try:
        yield
    finally:
        _scan_windows.reset(tok)


def scan_window_active() -> bool:
    """True inside any scan_window context (a tiled pass is binding)."""
    return bool(_scan_windows.get())


def scan_unit_count(data, manifest=None) -> int:
    """Number of bindable units (column batches + row-buffer chunks)."""
    if manifest is None:
        manifest = mvcc.snapshot_of(data)
    n_chunks = -(-manifest.row_count // data.capacity) \
        if manifest.row_count > 0 else 0
    return len(manifest.views) + n_chunks


def current_scan_scale(data) -> float:
    """How many windows the active tile pass splits `data`'s scan into
    (1.0 outside a tile pass).  The exact-decimal sum overflow guard
    multiplies its per-tile max|v|*count bound by this, so the bound
    covers the MERGED total across tiles, not just each tile."""
    wentry = (_scan_windows.get() or {}).get(id(data))
    if wentry is None:
        return 1.0
    lo, hi, manifest, width = wentry
    total = scan_unit_count(data, manifest)
    # the nominal width, not this window's: a truncated last window would
    # over-scale the guard into spurious host fallbacks
    return float(max(1, -(-total // max(1, width))))


@dataclasses.dataclass
class DeviceTable:
    schema: T.Schema
    num_batches: int           # padded
    capacity: int
    valid: torch.Tensor        # bool [B, C]
    # col_idx -> [B, C] decoded plate, OR a CodePlate / RlePlate /
    # BitPlate when the column stays resident encoded — consumers branch
    # structurally
    columns: Dict[int, object]
    dictionaries: Dict[int, np.ndarray]      # string col -> host values
    stats_min: Dict[int, np.ndarray]         # numeric col -> host [B]
    stats_max: Dict[int, np.ndarray]
    total_rows: int
    nulls: Dict[int, Optional[torch.Tensor]] = dataclasses.field(
        default_factory=dict)                # col_idx -> bool [B, C] or None
    # col_idx -> (sorted host dicts [B, Dp] f64, sizes [B]) for every
    # column with VALUE_DICT batches — the dictionary-domain batch
    # skipper probes equality literals here at bind time
    dict_domains: Dict[int, tuple] = dataclasses.field(default_factory=dict)


_COMPRESSIBLE = {Encoding.VALUE_DICT: "dict", Encoding.RUN_LENGTH: "rle",
                 Encoding.BOOLEAN_BITSET: "bitset"}


def _compressed_mode(is_str: bool, dec_exact: bool, cols_enc,
                     any_delta: bool, has_row_chunks: bool,
                     code_ok: bool = True,
                     count: bool = False) -> Optional[str]:
    """Per-column compressed-domain decision: 'dict' | 'rle' | 'bitset'
    when the column can stay resident encoded, None for a decoded bind.
    `code_ok=False` (a device-join relation) forces a decoded bind, as
    does an exact decimal (its device plate is the scaled int64 value,
    the encoded forms hold host-domain floats) and an update delta on
    the column (its values are no longer the encoded ones; deletes ride
    the validity plate and keep the encoded form).  With count=True (the
    cache-miss build) every decode-first reroute of a compressible
    column is counted by reason, as in the reference."""
    knob = str(config.global_properties().get(
        "scan_compressed_domain", "auto") or "auto").lower()
    encs = {c.encoding for c in cols_enc}
    compressible = bool(encs & set(_COMPRESSIBLE))
    if is_str or not cols_enc:
        return None   # string codes ARE the compressed domain already

    def reject(reason: str) -> None:
        if count and compressible:
            _dd.compressed_fallback(reason)

    if knob not in ("on", "auto"):
        reject("disabled")
        return None
    if dec_exact:
        reject("decimal_exact")
        return None
    if not config.global_properties().device_decode:
        reject("device_decode_off")
        return None
    if not code_ok:
        reject("join_key")
        return None
    if any_delta:
        reject("deltas")
        return None
    if has_row_chunks:
        reject("row_buffer")
        return None
    if len(encs) == 1 and next(iter(encs)) in _COMPRESSIBLE:
        return _COMPRESSIBLE[next(iter(encs))]
    if count and (compressible or knob == "on"):
        _dd.compressed_fallback(
            "mixed_encoding" if compressible else "not_encoded")
    return None


def _scan_units(data: ColumnTableData, manifest=None):
    """THE unit-splitting contract shared by the device bind and the host
    fallback: (manifest, views, row_chunks, window) honoring the active
    scan window — pinned snapshot, unit order (column batches, then
    row-buffer chunks of `capacity` rows), [lo, hi) slice.  Both sides
    read through this one helper: if they disagreed on unit order, a
    tile falling back to the host would read other rows than the device
    tile it replaces.  row_chunks are (start, take) row-buffer slices."""
    wentry = (_scan_windows.get() or {}).get(id(data))
    window = None
    if wentry is not None:
        window = (wentry[0], wentry[1])
        if wentry[2] is not None:
            manifest = wentry[2]
    if manifest is None:
        # the statement's pinned snapshot (storage/mvcc): the device bind
        # and the host fallback both read the pinned epoch, so concurrent
        # ingest never changes a query mid-flight
        manifest = mvcc.snapshot_of(data)
    views = list(manifest.views)
    row_chunks = []
    pos = 0
    while pos < manifest.row_count:
        take = min(data.capacity, manifest.row_count - pos)
        row_chunks.append((pos, take))
        pos += take
    if window is not None:
        units = [("v", v) for v in views] + [("r", rc) for rc in row_chunks]
        units = units[window[0]:window[1]]
        views = [u for k, u in units if k == "v"]
        row_chunks = [u for k, u in units if k == "r"]
    return manifest, views, row_chunks, window


def host_scan_units(data: ColumnTableData, manifest=None):
    """(manifest, views, row_chunks) for a HOST-side scan of `data`: the
    host fallback's view of the same units build_device_table binds."""
    manifest, views, row_chunks, _window = _scan_units(data, manifest)
    return manifest, views, row_chunks


def build_device_table(data: ColumnTableData, col_indices: Sequence[int],
                       device: torch.device,
                       code_ok: bool = True) -> DeviceTable:
    """Materialize `col_indices` of the current snapshot (or of the active
    scan window's pinned snapshot) on `device`, with caching keyed on
    (manifest version, device, window) so repeated queries over an
    unchanged table upload nothing.  `code_ok=False` (device-join
    relations, whose cached build artifacts and probe-key encodes read
    flat decoded layouts) forces decoded plates."""
    manifest, views, row_chunks, window = _scan_units(data)
    cache_key = (manifest.version, str(device), window)
    cache = data._device_cache.setdefault(cache_key, {})
    # stale versions of this device go: their plates are dead weight —
    # except the versions an active snapshot pin holds (a pinned reader
    # re-binding its old epoch must not have its plates evicted by a
    # newer version's bind).  list() snapshots are atomic under the GIL:
    # the tile prefetcher's worker inserts window entries concurrently
    pinned = mvcc.pinned_versions(data)
    for k in [k for k in list(data._device_cache)
              if k[1] == cache_key[1] and k[0] != manifest.version
              and k[0] not in pinned]:
        data._device_cache.pop(k, None)
    if window is not None:
        # a tile pass must not accumulate every window's plates (the
        # table is oversized by definition): keep only this window and
        # the windows a live prefetch pass owns (storage/prefetch) —
        # evicting the look-ahead window the worker just uploaded would
        # make the prefetcher a strict slowdown
        from snappydata_tpu_torch.storage import prefetch as _prefetch

        kept = _prefetch.keep_windows(data)
        for k in [k for k in list(data._device_cache)
                  if k != cache_key and k[1] == cache_key[1]
                  and k[2] is not None and k[2] not in kept]:
            data._device_cache.pop(k, None)

    def place(host_array: np.ndarray) -> torch.Tensor:
        return _dd.upload(host_array, device)

    schema = data.schema
    cap = data.capacity
    b_actual = len(views) + len(row_chunks)
    b = batch_bucket(b_actual) \
        if config.global_properties().batches_pow2_bucketing \
        else max(1, b_actual)
    b = max(b, 1)
    if "valid" not in cache:
        valid = np.zeros((b, cap), dtype=np.bool_)
        for i, v in enumerate(views):
            valid[i] = v.live_mask()
        for j, (_, take) in enumerate(row_chunks):
            valid[len(views) + j, :take] = True
        # counted once per bind: a tile's row count is not the table's,
        # and summing every delete mask again at each execution is not free
        cache["nrows"] = int(valid.sum()) if window is not None \
            else manifest.total_rows()
        cache["valid"] = place(valid)

    columns: Dict[int, object] = {}
    dicts: Dict[int, np.ndarray] = {}
    stats_min: Dict[int, np.ndarray] = {}
    stats_max: Dict[int, np.ndarray] = {}
    nulls: Dict[int, Optional[torch.Tensor]] = {}
    dict_domains: Dict[int, tuple] = {}
    for ci in col_indices:
        f = schema.fields[ci]
        is_str = f.dtype.name == "string"
        if is_str:
            dicts[ci] = data.dictionary(ci)
        dt = f.dtype.device_dtype()
        # exact decimals: HOST plates are float64 (the SQL value domain);
        # the DEVICE plate is the scaled int64 unscaled value
        dec_exact = f.dtype.name == "decimal" and dt.kind == "i"
        cols_enc = [v.batch.columns[ci] for v in views]
        # only deltas that target THIS column cost it its encoded form
        any_delta = any(any(d[0] == ci for d in v.deltas) for v in views)
        cd_mode = _compressed_mode(is_str, dec_exact, cols_enc, any_delta,
                                   bool(row_chunks), code_ok)
        key = ("ccol", ci) if cd_mode else ("col", ci)
        if key not in cache:
            _compressed_mode(is_str, dec_exact, cols_enc, any_delta,
                             bool(row_chunks), code_ok, count=True)
            cache[key] = _build_code_column(cd_mode, views, cols_enc, ci, b,
                                            cap, dt, device, place, cache) \
                if cd_mode else \
                _build_decoded_column(data, manifest, views, row_chunks, ci,
                                      f, b, cap, dt, place, cache)
        columns[ci], stats_min[ci], stats_max[ci], nulls[ci] = cache[key]
        dom = cache.get(("dictdom", ci))
        if dom is not None:
            dict_domains[ci] = dom
    return DeviceTable(schema, b, cap, cache["valid"], columns, dicts,
                       stats_min, stats_max,
                       cache["nrows"], nulls,
                       dict_domains)


def _null_plate(views, ci, b, cap):
    null_mask = np.zeros((b, cap), dtype=np.bool_)
    any_null = False
    for i, v in enumerate(views):
        nm = v.null_mask(ci)
        if nm is not None:
            null_mask[i] = nm
            any_null = True
    return null_mask, any_null


def _build_code_column(mode, views, cols_enc, ci, b, cap, dt, device, place,
                       cache):
    """Compressed-domain bind of a column whose batches all encode as
    VALUE_DICT ('dict'), RUN_LENGTH ('rle') or BOOLEAN_BITSET
    ('bitset'): the column stays resident encoded."""
    null_mask, any_null = _null_plate(views, ci, b, cap)
    smin = np.full(b, np.nan)
    smax = np.full(b, np.nan)
    for i, col in enumerate(cols_enc):
        st = col.stats
        if st is not None and st.min is not None:
            smin[i], smax[i] = float(st.min), float(st.max)
        elif mode == "dict" and len(col.dictionary):
            smin[i] = float(np.min(col.dictionary))
            smax[i] = float(np.max(col.dictionary))
        elif mode == "rle" and len(col.data):
            smin[i] = float(np.min(col.data))
            smax[i] = float(np.max(col.data))
        elif mode == "bitset" and col.num_rows:
            bits = bitmask.unpack(col.data, col.num_rows)
            smin[i] = float(bits.min())
            smax[i] = float(bits.max())
    if mode == "dict":
        plate, host_dicts, sizes = _dd.code_plates(cols_enc, b, cap, dt,
                                                   device)
        cache[("dictdom", ci)] = (host_dicts, sizes)
    elif mode == "rle":
        plate = _dd.rle_plates(cols_enc, b, cap, dt, device)
    else:
        plate = _dd.bit_plates(cols_enc, b, cap, device)
    return plate, smin, smax, place(null_mask) if any_null else None


def _build_decoded_column(data, manifest, views, row_chunks, ci, f, b, cap,
                          dt, place, cache):
    """Decoded [b, cap] plate: every batch decodes on the host (the
    reference decodes the encoded batches of a mixed column in-trace
    instead; the values are identical), deltas merged
    (`BatchView.decoded_column`), and row-buffer chunks append after the
    batches.  A batch with deltas takes its stats from its live decoded
    values, never from the encoded column's.  An exact decimal converts to its scaled int64 value
    here; its stats stay in the host (unscaled) domain, which is what
    sargable predicate literals compare against."""
    is_str = f.dtype.name == "string"
    dec_exact = f.dtype.name == "decimal" and np.dtype(dt).kind == "i"
    stacked = np.zeros((b, cap), dtype=dt)
    null_mask, any_null = _null_plate(views, ci, b, cap)
    smin = np.full(b, np.nan)
    smax = np.full(b, np.nan)
    for i, v in enumerate(views):
        col = v.batch.columns[ci]
        decoded = v.decoded_column(ci)
        stacked[i] = T.decimal_to_unscaled(f.dtype, decoded) \
            if dec_exact else decoded
        st = col.stats
        if st is not None and not v.deltas and not is_str \
                and st.min is not None:
            smin[i], smax[i] = float(st.min), float(st.max)
        elif not is_str and v.batch.num_rows:
            live = decoded[v.live_mask()]
            if live.size:
                smin[i], smax[i] = float(live.min()), float(live.max())
    for j, (pos, take) in enumerate(row_chunks):
        src = manifest.row_arrays[ci][pos:pos + take]
        chunk_nulls = None
        if manifest.row_nulls and manifest.row_nulls[ci] is not None:
            chunk_nulls = manifest.row_nulls[ci][pos:pos + take]
        if is_str:
            lookup = data._dict_lookup[ci]
            # None (SQL NULL) maps to code 0; nullability is carried by
            # validity, not the code stream
            vals = np.fromiter(
                (lookup[x] if x is not None else 0 for x in src),
                dtype=np.int32, count=take)
            none_mask = np.fromiter((x is None for x in src),
                                    dtype=np.bool_, count=take)
            chunk_nulls = none_mask if chunk_nulls is None \
                else (chunk_nulls | none_mask)
        elif dec_exact:
            vals = T.decimal_to_unscaled(f.dtype, src)
        else:
            vals = np.asarray(src).astype(dt)
        if chunk_nulls is not None and chunk_nulls.any():
            null_mask[len(views) + j, :take] = chunk_nulls
            any_null = True
        stacked[len(views) + j, :take] = vals
        if not is_str and take:
            stat_src = np.asarray(src, dtype=np.float64) \
                if dec_exact else vals
            smin[len(views) + j] = float(stat_src.min())
            smax[len(views) + j] = float(stat_src.max())
    if not is_str:
        dom = _dict_domain(views, ci, b)
        if dom is not None:
            cache[("dictdom", ci)] = dom
    return place(stacked), smin, smax, place(null_mask) if any_null else None


def _dict_domain(views, ci: int, b: int):
    """(sorted host dicts [b, Dp] f64, sizes [b]) of a column's
    VALUE_DICT batches — the dictionary-domain batch skipper's probe
    surface.  Batches without a usable dictionary report size 0 = keep."""
    vd = [(i, v.batch.columns[ci]) for i, v in enumerate(views)
          if v.batch.columns[ci].encoding == Encoding.VALUE_DICT
          and v.batch.columns[ci].dictionary is not None
          and len(v.batch.columns[ci].dictionary)]
    if not vd:
        return None
    d_pad = max(len(c.dictionary) for _, c in vd)
    host = np.zeros((b, d_pad), dtype=np.float64)
    sizes = np.zeros(b, dtype=np.int64)
    for i, c in vd:
        d = np.asarray(c.dictionary, dtype=np.float64)
        host[i, :d.shape[0]] = d
        if d.shape[0] < d_pad:
            host[i, d.shape[0]:] = d[-1]
        sizes[i] = d.shape[0]
    return host, sizes


def numeric_key_domain(data: ColumnTableData, ci: int, max_card: int):
    """Table-global sorted value domain of a numeric column at the current
    snapshot — the code space of the vdict group-by lane
    (engine/executor._emit_aggregate).  Returned in the column's DEVICE
    dtype, so searchsorted hits are exact against plates cast from the
    same host values.  None (the caller's cue to leave the device path)
    when the column exceeds `max_card` distinct values or holds NaN.
    Cached per (manifest version, column)."""
    man = mvcc.snapshot_of(data)
    cache = data.__dict__.setdefault("_key_domain_cache", {})
    key = (man.version, ci, max_card)
    if key in cache:
        return cache[key]
    dt = data.schema.fields[ci].dtype.device_dtype()
    parts = []
    for v in man.views:
        col = v.batch.columns[ci]
        untouched = not any(d[0] == ci for d in v.deltas)
        if untouched and col.encoding == Encoding.VALUE_DICT \
                and col.dictionary is not None:
            parts.append(np.asarray(col.dictionary))
        elif untouched and col.encoding == Encoding.RUN_LENGTH:
            parts.append(np.asarray(col.data))
        else:
            # deltas / mixed encodings: the domain must cover the values
            # a decoded bind groups by
            parts.append(np.asarray(v.decoded_column(ci)))
    if man.row_count:
        parts.append(np.asarray(man.row_arrays[ci][:man.row_count]))
    if parts:
        dom = np.unique(np.concatenate(
            [p.astype(dt, copy=False).ravel() for p in parts]))
    else:
        dom = np.zeros(0, dtype=dt)
    if len(dom) > max_card or (dom.dtype.kind == "f" and len(dom)
                               and np.isnan(dom[-1])):
        dom = None
    for k in [k for k in cache if k[0] != man.version]:
        del cache[k]
    cache[key] = dom
    return dom
