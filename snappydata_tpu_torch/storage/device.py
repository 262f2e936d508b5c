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

ARRAY (numeric or STRING elements), MAP<STRING, numeric | STRING> and
flat STRUCT columns bind as fixed-width plates: values [B, C, L] with
lengths [B, C] and element-null bits, key-code plus value plates, and one
[B, C] plate per struct field; their string parts ride as codes of the
table's append-only dictionaries.  Nested complex types stay host-side.

Per-batch min/max stats ride along host-side for predicate batch
skipping (ref: stats-row filter codegen, columnBatchesSkipped metric,
ColumnTableScan.scala:115-130).  Plates are cached per (manifest
version, device, scan window).

Device memory is accounted (the resource broker's device ledger): an
entry's bytes are its TENSORS' bytes, each storage counted once
(`_entry_bytes`: views and plate tuples share storages), not what the
caching allocator reports.  `device_cache_bytes` caps the cache with LRU
eviction (`_DeviceCacheBudget`) that never drops a pinned epoch's entries
or a window a live prefetch pass keeps; a storage two entries share (a
mesh entry seeded from the single-device one) is charged once.

Tiled scans bind a WINDOW of the table's scan units (column batches,
then row-buffer chunks of `capacity` rows): `scan_window` restricts
`build_device_table` to units [lo, hi) of a pinned manifest, and the
host fallback reads the same units through `host_scan_units`.

Under an active slot mesh (parallel/mesh.py) a bind is a MESH bind: the
batch axis pads to `shard_bucket(B, slots)`, the plates live on the
mesh's home device and slot i reads the contiguous block i of them (a
view; `MeshContext.block`), encoded plates sharded as they are.  Where
the slots span cards, each slot on another card gets a copy of its
blocks there once, at the bind (`parallel.mesh.place_remote_blocks`).  The
cache key carries the mesh token instead of the device, binds under a
new token prune the stale placements, and a mesh bind on one device
takes the single-device entry's tensors when their padding already
divides by the slot count, so the table is never held twice.  A live
mesh resize re-keys resident entries (`migrate_mesh_cache`) instead of
re-uploading them, and `device_cache_bytes_by_device` reports each
slot's blocks where they reside.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
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
from snappydata_tpu_torch.utils import locks


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
    # the MeshContext of a mesh bind (None for a single-device bind): its
    # slots split the batch axis (a row table's mesh bind is replicated)
    mesh: object = None

    def column(self, idx: int):
        return self.columns[idx]


_COMPRESSIBLE = {Encoding.VALUE_DICT: "dict", Encoding.RUN_LENGTH: "rle",
                 Encoding.BOOLEAN_BITSET: "bitset"}


def _compressed_mode(is_str: bool, dec_exact: bool, cols_enc,
                     any_delta: bool, has_row_chunks: bool,
                     code_ok: bool = True,
                     count: bool = False, table=None) -> Optional[str]:
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
            _dd.compressed_fallback(reason, table=table)

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
            "mixed_encoding" if compressible else "not_encoded",
            table=table)
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
    scan window's pinned snapshot) on `device` — on the active mesh's home
    device under a mesh — with caching keyed on (manifest version, device
    or mesh token, window) so repeated queries over an unchanged table
    upload nothing.  `code_ok=False` (device-join relations, whose cached
    build artifacts and probe-key encodes read flat decoded layouts)
    forces decoded plates."""
    from snappydata_tpu_torch.parallel.mesh import (MeshContext,
                                                    round_up_to,
                                                    shard_batches,
                                                    shard_bucket)

    ctx = MeshContext.current()
    manifest, views, row_chunks, window = _scan_units(data)
    if ctx is not None:
        device = ctx.home_for(device)
    placement = ctx.token if ctx is not None else str(device)
    cache_key = (manifest.version, placement, window)
    cache = data._device_cache.setdefault(cache_key, {})
    # stale versions of this placement go: their plates are dead weight —
    # except the versions an active snapshot pin holds (a pinned reader
    # re-binding its old epoch must not have its plates evicted by a
    # newer version's bind).  A mesh bind also drops the entries of other
    # (dead) mesh tokens, as the reference prunes stale placements.
    # list() snapshots are atomic under the GIL: the tile prefetcher's
    # worker inserts window entries concurrently
    pinned = mvcc.pinned_versions(data)
    for k in [k for k in list(data._device_cache)
              if k != cache_key and k[0] not in pinned
              and ((k[1] == placement and k[0] != manifest.version)
                   or (ctx is not None and isinstance(k[1], int)
                       and k[1] != placement))]:
        data._device_cache.pop(k, None)
        _cache_budget.forget(data._device_cache, k)
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
            _cache_budget.forget(data._device_cache, k)

    def place(host_array: np.ndarray) -> torch.Tensor:
        return shard_batches(host_array, ctx, device)

    schema = data.schema
    cap = data.capacity
    b_actual = len(views) + len(row_chunks)
    pow2 = config.global_properties().batches_pow2_bucketing
    b = batch_bucket(b_actual) if pow2 else max(1, b_actual)
    b = max(b, 1)
    if ctx is not None:
        # the batch axis is the sharded axis: pad to a SLOT-DIVISIBLE
        # ladder size, so a resharded table keeps the single-device
        # ladder's shapes
        b = shard_bucket(b, ctx.num_devices) if pow2 \
            else round_up_to(b, ctx.num_devices)
        cache["mesh"] = ctx
        if "valid" not in cache:
            _share_single_device_entry(data, cache, manifest.version,
                                       window, device, b)
    if "valid" in cache:
        # a partially-filled entry pins the padded batch shape: a MIGRATED
        # entry (live mesh resize) keeps its old padding, and a column
        # bound fresh into it must match
        b = int(cache["valid"].shape[0])
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
        builder = _complex_builder(f.dtype)
        if builder is not None:
            # ARRAY / MAP / flat STRUCT: fixed-width plates, string parts
            # as codes of the table's append-only dictionaries — the
            # device lowering of size / element_at / array_contains reads
            # them (ref: SerializedArray fixed-width fast path)
            key = (builder.__name__, ci)
            if key not in cache:
                cache[key] = builder(data, manifest, views, row_chunks, ci,
                                     f, b, cap, place)
            columns[ci], stats_min[ci], stats_max[ci], nulls[ci] = \
                cache[key]
            continue
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
        # compressed-domain eligibility is mesh-agnostic: encoded plates
        # are [B, ...]-leading, so they shard over the slots the same way
        # decoded plates do
        cd_mode = _compressed_mode(is_str, dec_exact, cols_enc, any_delta,
                                   bool(row_chunks), code_ok)
        key = ("ccol", ci) if cd_mode else ("col", ci)
        if key not in cache:
            _compressed_mode(is_str, dec_exact, cols_enc, any_delta,
                             bool(row_chunks), code_ok, count=True,
                             table=data)
            cache[key] = _build_code_column(cd_mode, views, cols_enc, ci, b,
                                            cap, dt, device, place, cache) \
                if cd_mode else \
                _build_decoded_column(data, manifest, views, row_chunks, ci,
                                      f, b, cap, dt, place, cache)
        columns[ci], stats_min[ci], stats_max[ci], nulls[ci] = cache[key]
        dom = cache.get(("dictdom", ci))
        if dom is not None:
            dict_domains[ci] = dom
    if ctx is not None and ctx.spans_cards:
        place_remote(cache, ctx, b)
    if _cache_budget.enabled():
        _cache_budget.touch(data._device_cache, cache_key, cache, data=data)
    return DeviceTable(schema, b, cap, cache["valid"], columns, dicts,
                       stats_min, stats_max,
                       cache["nrows"], nulls,
                       dict_domains, ctx)


def place_remote(cache, ctx, b: int) -> None:
    """Give every slot on another card than the home one a copy of its
    block of each [b, ...] plate under `cache` (a cache entry, or an
    exchanged relation), once (fenced like the upload inside a prefetch
    worker)."""
    from snappydata_tpu_torch.parallel import mesh as _mesh

    fence = _mesh.dispatch_lock if _mesh._prefetch_fencing.get() \
        else contextlib.nullcontext()
    with fence:
        for t in _tensor_leaves(cache):
            if t.dim() and int(t.shape[0]) == b:
                _mesh.place_remote_blocks(t, ctx.mesh)


def _same_device(name: str, device: torch.device) -> bool:
    """Whether a single-device cache key's device string names `device`
    (`cuda` is the current card)."""
    try:
        d = torch.device(name)
    except (RuntimeError, TypeError):
        return False
    if d.type != device.type:
        return False
    if d.type != "cuda":
        return True
    idx = d.index if d.index is not None else torch.cuda.current_device()
    want = device.index if device.index is not None \
        else torch.cuda.current_device()
    return idx == want


def _share_single_device_entry(data, cache, version, window, home,
                               b: int) -> None:
    """Seed a fresh mesh entry with the single-device entry's tensors of
    the same version and window on the home device, when the mesh's slots
    all sit there and that entry's padding is the mesh's: the slots' blocks
    are then views of the plates already resident, and nothing uploads."""
    ctx = cache["mesh"]
    if any(s.device != home for s in ctx.mesh.slots):
        return
    for k, src in list(data._device_cache.items()):
        if not isinstance(k[1], str) or k[0] != version or k[2] != window \
                or not isinstance(src, dict) or "valid" not in src \
                or not _same_device(k[1], home):
            continue
        if int(src["valid"].shape[0]) != b:
            continue
        for key, val in list(src.items()):
            cache.setdefault(key, val)
        return


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
        # a rebuilt column's probe surface replaces any earlier one: the
        # skipper must never probe a dictionary the deltas outdate
        dom = _dict_domain(views, ci, b)
        if dom is not None:
            cache[("dictdom", ci)] = dom
        else:
            cache.pop(("dictdom", ci), None)
    return place(stacked), smin, smax, place(null_mask) if any_null else None


def _dict_domain(views, ci: int, b: int):
    """(sorted host dicts [b, Dp] f64, sizes [b]) of a column's
    VALUE_DICT batches — the dictionary-domain batch skipper's probe
    surface.  Batches without a usable dictionary (other encodings, or
    update deltas touching this column) report size 0 = always keep."""
    vd = [(i, v.batch.columns[ci]) for i, v in enumerate(views)
          if v.batch.columns[ci].encoding == Encoding.VALUE_DICT
          and not any(d[0] == ci for d in v.deltas)
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


# --------------------------------------------------------------------------
# complex-typed columns (ref snappydata_tpu/storage/device.py:641-864)
# --------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def array_device_eligible(dt) -> bool:
    """ARRAY of a numeric or STRING element gets device plates; other
    element types (nested complex values) stay host-evaluated."""
    el = getattr(dt, "element", None)
    return el is not None and (T.is_numeric(el) or el.name == "string")


def map_device_eligible(dt) -> bool:
    """MAP<STRING, numeric|string> gets device plates; other key / value
    types stay host-evaluated."""
    return (getattr(dt, "key", None) is not None
            and dt.key.name == "string"
            and (T.is_numeric(dt.value) or dt.value.name == "string"))


def struct_device_eligible(dt) -> bool:
    """STRUCT with only numeric / string fields gets per-field plates;
    nested complex fields keep the host path."""
    fields = getattr(dt, "fields", ())
    return bool(fields) and all(
        T.is_numeric(ft) or ft.name == "string" for _n, ft in fields)


def complex_device_eligible(dt) -> bool:
    """Whether a complex column type binds as device plates at all."""
    return _complex_builder(dt) is not None


def _complex_builder(dt):
    if isinstance(dt, T.StructType) and struct_device_eligible(dt):
        return _build_struct_column
    if isinstance(dt, T.MapType) and map_device_eligible(dt):
        return _build_map_column
    if isinstance(dt, T.ArrayType) and array_device_eligible(dt):
        return _build_array_column
    return None


def _complex_column_sources(manifest, views, row_chunks, ci):
    """(batch row, decoded cells, null mask) triples of a complex column
    — the one assembly the three complex-plate builders share."""
    sources = []
    for i, v in enumerate(views):
        sources.append((i, v.decoded_column(ci), v.null_mask(ci)))
    for j, (pos, take) in enumerate(row_chunks):
        src = np.asarray(manifest.row_arrays[ci][pos:pos + take],
                         dtype=object)
        rn = None
        if manifest.row_nulls and manifest.row_nulls[ci] is not None:
            rn = manifest.row_nulls[ci][pos:pos + take]
        sources.append((len(views) + j, src, rn))
    return sources


def _value_plate_dtype(vt) -> np.dtype:
    """Fill dtype of a complex type's VALUE plate: exact decimals fill as
    plain float64 and convert to scaled int64 afterwards (writing raw
    values into the int64 device dtype would truncate them)."""
    dt = vt.device_dtype()
    if vt.name == "decimal" and dt.kind == "i":
        return np.dtype(np.float64)
    return dt


def _finish_value_plate(vt, plate: np.ndarray) -> np.ndarray:
    """Host-domain fill plate -> device plate (scale exact decimals)."""
    dt = vt.device_dtype()
    if vt.name == "decimal" and dt.kind == "i":
        return T.decimal_to_unscaled(vt, plate)
    return plate


def _row_nulls(null_mask, bi, cells_null, nm) -> bool:
    """OR a source's non-cell rows and its stored null mask into the
    [b, cap] row-null plate; True when any row of the source is NULL."""
    any_null = bool(cells_null.any())
    null_mask[bi, :len(cells_null)] |= cells_null
    if nm is not None:
        null_mask[bi, :len(nm)] |= np.asarray(nm, dtype=bool)
        any_null = True
    return any_null


def _flatten_cells(dec, is_cell, size_of):
    """(is-cell mask, per-row lengths, [(row, k, part), ...] flat parts)
    of one source's cells; `size_of(cell)` lists a cell's parts."""
    n = len(dec)
    cell = np.fromiter((is_cell(x) for x in dec), dtype=np.bool_, count=n)
    parts = [size_of(x) if c else () for x, c in zip(dec, cell)]
    lens = np.fromiter((len(p) for p in parts), dtype=np.int64, count=n)
    return cell, lens, parts


def _scatter_positions(lens: np.ndarray):
    """Row and in-cell position of every flat part of lengths `lens`."""
    total = int(lens.sum())
    rows = np.repeat(np.arange(lens.shape[0]), lens)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    return rows, np.arange(total) - starts


def _build_struct_column(data, manifest, views, row_chunks, ci, f, b, cap,
                         place):
    """STRUCT column -> ((field value plates, field null plates) in the
    dtype's field order, nan-stats, row-null mask).  String fields encode
    against per-field append-only dictionaries."""
    import itertools

    from snappydata_tpu_torch.storage.table_store import _struct_get

    sources = _complex_column_sources(manifest, views, row_chunks, ci)
    fnames = [n for n, _t in f.dtype.fields]
    ftypes = [t for _n, t in f.dtype.fields]
    str_fields = [fn for fn, ft in zip(fnames, ftypes)
                  if ft.name == "string"]
    # all string fields intern in ONE pass over the cells
    str_lookups = data.intern_struct_fields(
        ci, str_fields, itertools.chain.from_iterable(
            dec for _bi, dec, _nm in sources)) if str_fields else {}
    lookups = [str_lookups.get(fn) if ft.name == "string" else None
               for fn, ft in zip(fnames, ftypes)]
    fvals = [np.zeros((b, cap), dtype=np.int32 if lk is not None
                      else _value_plate_dtype(ft))
             for lk, ft in zip(lookups, ftypes)]
    fnuls = [np.zeros((b, cap), dtype=np.bool_) for _ in fnames]
    null_mask = np.zeros((b, cap), dtype=np.bool_)
    any_null = False
    for bi, dec, nm in sources:
        n = len(dec)
        cell = np.fromiter((isinstance(x, dict) for x in dec),
                           dtype=np.bool_, count=n)
        for k, (fn, lk) in enumerate(zip(fnames, lookups)):
            got = [_struct_get(x, fn) if c else None
                   for x, c in zip(dec, cell)]
            isnull = np.fromiter((v is None for v in got), dtype=np.bool_,
                                 count=n)
            fnuls[k][bi, :n] = isnull & cell
            if lk is not None:
                fvals[k][bi, :n] = np.fromiter(
                    (0 if v is None else lk[str(v)] for v in got),
                    dtype=np.int32, count=n)
            else:
                fvals[k][bi, :n] = np.array(
                    [0 if v is None else v for v in got],
                    dtype=fvals[k].dtype)
        any_null |= _row_nulls(null_mask, bi, ~cell, nm)
    fvals = [a if lk is not None else _finish_value_plate(ft, a)
             for a, lk, ft in zip(fvals, lookups, ftypes)]
    return ((tuple(place(a) for a in fvals), tuple(place(a) for a in fnuls)),
            np.full(b, np.nan), np.full(b, np.nan),
            place(null_mask) if any_null else None)


def _build_map_column(data, manifest, views, row_chunks, ci, f, b, cap,
                      place):
    """MAP<STRING, V> column -> ((key codes [b, cap, L], values [b, cap,
    L], lengths [b, cap], value nulls [b, cap, L]), nan-stats, row-null
    mask).  Keys (and string values) encode against the table's
    append-only map dictionaries, so plates of any pinned manifest stay
    valid."""
    import itertools

    val_is_str = f.dtype.value.name == "string"
    vdt = np.dtype(np.int32) if val_is_str \
        else _value_plate_dtype(f.dtype.value)
    sources = _complex_column_sources(manifest, views, row_chunks, ci)
    klookup, vlookup = data.intern_map_entries(
        ci, itertools.chain.from_iterable(
            dec for _bi, dec, _nm in sources))
    flat = [(bi, nm) + _flatten_cells(dec, lambda x: isinstance(x, dict),
                                      lambda x: list(x.items()))
            for bi, dec, nm in sources]
    maxlen = max([1] + [int(lens.max()) for *_x, lens, _p in flat
                        if lens.size])
    L = _next_pow2(maxlen)
    kcodes = np.full((b, cap, L), -1, dtype=np.int32)
    vals = np.zeros((b, cap, L), dtype=vdt)
    lengths = np.zeros((b, cap), dtype=np.int32)
    vnul = np.zeros((b, cap, L), dtype=np.bool_)
    null_mask = np.zeros((b, cap), dtype=np.bool_)
    any_null = False
    for bi, nm, cell, lens, parts in flat:
        lengths[bi, :lens.shape[0]] = lens
        items = list(itertools.chain.from_iterable(parts))
        if items:
            rows, ks = _scatter_positions(lens)
            m = len(items)
            kcodes[bi, rows, ks] = np.fromiter(
                (klookup[str(k)] for k, _v in items), dtype=np.int32,
                count=m)
            vn = np.fromiter((v is None for _k, v in items),
                             dtype=np.bool_, count=m)
            vnul[bi, rows, ks] = vn
            if val_is_str:
                vals[bi, rows, ks] = np.fromiter(
                    (0 if v is None else vlookup[str(v)]
                     for _k, v in items), dtype=np.int32, count=m)
            else:
                vals[bi, rows, ks] = np.array(
                    [0 if v is None else v for _k, v in items], dtype=vdt)
        any_null |= _row_nulls(null_mask, bi, ~cell, nm)
    if not val_is_str:
        vals = _finish_value_plate(f.dtype.value, vals)
    return ((place(kcodes), place(vals), place(lengths), place(vnul)),
            np.full(b, np.nan), np.full(b, np.nan),
            place(null_mask) if any_null else None)


def _build_array_column(data, manifest, views, row_chunks, ci, f, b, cap,
                        place):
    """Numeric / string ARRAY column -> ((values [b, cap, L], lengths [b,
    cap], element nulls [b, cap, L]), nan-stats, row-null mask).  String
    elements encode as int32 codes of the table's append-only element
    dictionary, so size / element_at / array_contains run on the device
    exactly like their numeric forms."""
    import itertools

    is_str = f.dtype.element.name == "string"
    sources = _complex_column_sources(manifest, views, row_chunks, ci)
    if is_str:
        edt = np.dtype(np.int32)
        # intern THIS pinned manifest's cells in one call, so the bind is
        # self-sufficient across recovery and concurrent mutation
        lookup = data.intern_array_elements(
            ci, itertools.chain.from_iterable(
                dec for _bi, dec, _nm in sources))
    else:
        edt = _value_plate_dtype(f.dtype.element)
    flat = [(bi, nm) + _flatten_cells(
        dec, lambda x: isinstance(x, (list, tuple, np.ndarray)), list)
        for bi, dec, nm in sources]
    maxlen = max([1] + [int(lens.max()) for *_x, lens, _p in flat
                        if lens.size])
    L = _next_pow2(maxlen)
    vals = np.zeros((b, cap, L), dtype=edt)
    lengths = np.zeros((b, cap), dtype=np.int32)
    enul = np.zeros((b, cap, L), dtype=np.bool_)
    null_mask = np.zeros((b, cap), dtype=np.bool_)
    any_null = False
    for bi, nm, cell, lens, parts in flat:
        lengths[bi, :lens.shape[0]] = lens
        els = list(itertools.chain.from_iterable(parts))
        if els:
            rows, ks = _scatter_positions(lens)
            m = len(els)
            enul[bi, rows, ks] = np.fromiter(
                (el is None for el in els), dtype=np.bool_, count=m)
            if is_str:
                vals[bi, rows, ks] = np.fromiter(
                    (0 if el is None else lookup[str(el)] for el in els),
                    dtype=np.int32, count=m)
            else:
                vals[bi, rows, ks] = np.array(
                    [0 if el is None else el for el in els], dtype=edt)
        any_null |= _row_nulls(null_mask, bi, ~cell, nm)
    if not is_str:
        vals = _finish_value_plate(f.dtype.element, vals)
    return ((place(vals), place(lengths), place(enul)),
            np.full(b, np.nan), np.full(b, np.nan),
            place(null_mask) if any_null else None)


# --- device-cache budget and ledger -------------------------------------

def _tensor_leaves(obj):
    """Every tensor inside one device-cache value: plates, plate
    NamedTuples (CodePlate, RlePlate, BitPlate, complex plates), null
    masks, whole DeviceTables (row tables cache those).  Host arrays
    (stats, dictionary domains) are not device bytes."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensor_leaves(x)
    elif isinstance(obj, dict):
        for x in list(obj.values()):
            yield from _tensor_leaves(x)
    elif isinstance(obj, DeviceTable):
        yield from _tensor_leaves(obj.valid)
        yield from _tensor_leaves(list(obj.columns.values()))
        yield from _tensor_leaves(list(obj.nulls.values()))


def _storage_bytes(tensors, seen=None) -> int:
    """Bytes of the distinct storages under `tensors`: a view, a slice or
    a plate shared by two tuples is one allocation, counted once (by
    `untyped_storage().nbytes()`, as the allocator holds it)."""
    seen = set() if seen is None else seen
    total = 0
    for t in tensors:
        st = t.untyped_storage()
        key = (t.device.type, t.device.index, st.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        total += int(st.nbytes())
    return total


def _entry_tensors(entry) -> list:
    """The device tensors one cache entry holds (a column table's
    per-column dict or a row table's DeviceTable), with the copies of its
    blocks on other cards.  list() snapshots: a prefetch worker may still
    be filling the entry while a ledger walk measures it."""
    from snappydata_tpu_torch.parallel.mesh import remote_blocks_of

    leaves = list(_tensor_leaves(entry))
    return leaves + [c for t in leaves for c in remote_blocks_of(t)]


def _entry_bytes(entry) -> int:
    """Device bytes of one cache entry, each storage counted once."""
    return _storage_bytes(_entry_tensors(entry))


def _entry_storages(entry) -> Dict[tuple, int]:
    """{(device type, index, storage pointer): bytes} of one entry."""
    out: Dict[tuple, int] = {}
    for t in _entry_tensors(entry):
        st = t.untyped_storage()
        out[(t.device.type, t.device.index, st.data_ptr())] = \
            int(st.nbytes())
    return out


class _DeviceCacheBudget:
    """Process-wide accounting of cached device tensors with LRU eviction
    (ref: SnappyUnifiedMemoryManager evicting under memory pressure; here
    eviction drops device copies back to the host batches they rebuild
    from on the next bind)."""

    def __init__(self):
        self._lock = locks.named_lock("storage.device_cache")
        # (id(table_cache_dict), repr(cache_key)) ->
        #   ({storage: bytes}, tick, cache dict, cache key,
        #    table weakref | None)
        # the charge is the UNION of the entries' storages: a storage two
        # entries share (a mesh entry seeded from the single-device one)
        # is charged once, and evicting one of them frees nothing of it
        self._entries: Dict = {}
        self._tick = 0

    def _total(self, table_cache=None) -> int:
        held: Dict[tuple, int] = {}
        for e in self._entries.values():
            if table_cache is None or e[2] is table_cache:
                held.update(e[0])
        return sum(held.values())

    def charged_bytes(self, table_cache=None) -> int:
        """Bytes the budget holds charged (each storage once), for one
        table's `_device_cache` or for all."""
        with self._lock:
            return self._total(table_cache)

    def _budget(self) -> int:
        return int(config.global_properties().device_cache_bytes or 0)

    def enabled(self) -> bool:
        return self._budget() > 0

    def forget(self, table_cache: Dict, cache_key) -> None:
        """Version pruning dropped this entry: stop counting its bytes."""
        if not self._entries:
            return
        with self._lock:
            self._entries.pop((id(table_cache), repr(cache_key)), None)

    def touch(self, table_cache: Dict, cache_key, entry,
              data=None) -> None:
        budget = self._budget()
        if budget <= 0:
            return
        storages = _entry_storages(entry)
        from snappydata_tpu_torch.observability.metrics import \
            global_registry
        from snappydata_tpu_torch.storage import prefetch as _prefetch

        reg = global_registry()
        with self._lock:
            self._tick += 1
            # the owning cache dict lives with its table anyway; the
            # table itself is a weakref, consulted only to spare pinned
            # epochs and live prefetch windows
            self._entries[(id(table_cache), repr(cache_key))] = (
                storages, self._tick, table_cache, cache_key,
                weakref.ref(data) if data is not None else None)
            total = self._total()
            if total <= budget:
                return
            for key, (_st, _, owner, ck, dref) in sorted(
                    self._entries.items(), key=lambda kv: kv[1][1]):
                if total <= budget:
                    break
                d = dref() if dref is not None else None
                if d is not None:
                    # NEVER evict a pinned epoch's plates out from under a
                    # live scan: the lock-free peek keeps the MVCC clock
                    # out from under this lock
                    pins = mvcc.pinned_versions_peek(d)
                    if pins is None or ck[0] in pins:
                        reg.inc("tier_pinned_skips")
                        continue
                    # ... nor the window a prefetch pass holds (the
                    # look-ahead the worker just uploaded, or the tile
                    # the consumer is running): the prefetch lock is a
                    # leaf, so taking it here adds no cycle
                    if ck[2] is not None \
                            and ck[2] in _prefetch.keep_windows(d):
                        reg.inc("device_cache_window_skips")
                        continue
                owner.pop(ck, None)  # device tensors released
                self._entries.pop(key, None)
                total = self._total()
                reg.inc("device_cache_evictions")


_cache_budget = _DeviceCacheBudget()


def device_cache_bytes_by_table(tables) -> Dict[str, int]:
    """Device-side ledger of the resource broker: cached plate bytes per
    table, read off each table's `_device_cache` (pull-based: dropped
    tables stop appearing).  `tables` is an iterable of (name, data).
    Storages shared between a table's entries count once."""
    out: Dict[str, int] = {}
    for name, data in tables:
        caches = getattr(data, "_device_cache", None)
        if not caches:
            continue
        try:  # same-named tables of different catalogs sum
            out[name] = out.get(name, 0) + _storage_bytes(
                _tensor_leaves(list(caches.values())))
        except Exception:
            out.setdefault(name, 0)
    return out


def _entry_mesh(entry):
    """The MeshContext a cache entry was bound under, or None."""
    if isinstance(entry, DeviceTable):
        return entry.mesh
    return entry.get("mesh") if isinstance(entry, dict) else None


def device_cache_bytes_by_device(tables) -> Dict[str, int]:
    """Resident plate bytes per DEVICE — per SLOT for mesh-bound entries
    (`slot<i>:<device>`), the mesh dashboard's proof that sharded tables
    stay encoded per slot: a sharded plate gives each slot its block's
    bytes, a replicated one (a row table under a mesh) its whole bytes on
    every slot.  A slot on another card than the home one counts the copy
    of its block held there, and the home card (`<device>`) the block's
    bytes it keeps in the whole plate.  Single-device entries count their
    distinct storages on their device."""
    from snappydata_tpu_torch.parallel.mesh import remote_block

    out: Dict[str, int] = {}
    seen: set = set()
    for _name, data in tables:
        caches = getattr(data, "_device_cache", None)
        if not caches:
            continue
        for entry in list(caches.values()):
            ctx = _entry_mesh(entry)
            if ctx is None:
                for t in _tensor_leaves(entry):
                    dev = str(t.device)
                    out[dev] = out.get(dev, 0) + _storage_bytes([t], seen)
                continue
            slots = ctx.mesh.slots
            home = ctx.home
            replicated = isinstance(entry, DeviceTable)
            for t in _tensor_leaves(entry):
                nbytes = t.numel() * t.element_size()
                per = t.shape[0] // len(slots) if t.dim() else 0
                for i, slot in enumerate(slots):
                    share = nbytes if replicated \
                        else nbytes // max(1, t.shape[0]) * per
                    key = str(slot)
                    if slot.device is not None and slot.device != home:
                        # a replicated table lives on the home card only
                        if replicated:
                            continue
                        copy = remote_block(t, i * per, (i + 1) * per,
                                            slot.device)
                        if copy is not None:
                            out[key] = out.get(key, 0) \
                                + copy.numel() * copy.element_size()
                        key = str(t.device)
                    out[key] = out.get(key, 0) + share
    return out


def migrate_mesh_cache(data, old_token, new_ctx):
    """Live bucket rebalance of one table's resident plates: every cache
    entry bound under `old_token` re-keys onto `new_ctx`'s mesh, its
    plates staying where they are — each slot of the new mesh reads its
    block of them (a view on the home device), so no byte re-uploads from
    the host.  Returns (entries_moved, bytes_moved): the bytes of the
    batches whose owning slot changed.  Entries whose padded batch axis
    the new slot count does not divide are left to rebuild at the next
    bind."""
    moved = bytes_moved = 0
    nd = new_ctx.num_devices
    for key in [k for k in list(data._device_cache)
                if len(k) >= 2 and k[1] == old_token]:
        entry = data._device_cache.get(key)
        if entry is None:
            continue
        new_key = (key[0], new_ctx.token) + tuple(key[2:])
        if isinstance(entry, DeviceTable):
            # a replicated row table: every slot holds all of it
            new_entry = dataclasses.replace(entry, mesh=new_ctx)
        else:
            valid = entry.get("valid")
            old_ctx = entry.get("mesh")
            if valid is None or old_ctx is None \
                    or valid.shape[0] % nd != 0:
                continue
            new_entry = dict(entry)
            new_entry["mesh"] = new_ctx
            b = int(valid.shape[0])
            nold = old_ctx.num_devices
            owners_moved = sum(1 for j in range(b)
                               if j * nold // b != j * nd // b)
            for t in _tensor_leaves(entry):
                if t.dim() and t.shape[0] == b:
                    bytes_moved += t.numel() * t.element_size() // b \
                        * owners_moved
        data._device_cache[new_key] = new_entry
        data._device_cache.pop(key, None)
        _cache_budget.forget(data._device_cache, key)
        if _cache_budget.enabled():
            _cache_budget.touch(data._device_cache, new_key, new_entry,
                                data=data)
        moved += 1
    return moved, bytes_moved
