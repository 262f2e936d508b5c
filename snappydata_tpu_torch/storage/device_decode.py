"""Compressed-domain column plates and their device consumers.

Port of snappydata_tpu/storage/device_decode.py: under
`scan_compressed_domain` an encoded column stays resident on the device
in its encoded form, and values decode lazily only where an expression
consumes them:

- VALUE_DICT -> `CodePlate`: uint8/uint16 codes plus tiny per-batch
  sorted dictionaries; predicates compare codes against literals
  translated through the sorted dictionary (`code_cmp_mask`), values
  decode with one gather (`code_values`).
- RUN_LENGTH -> `RlePlate`: run values plus cumulative run end offsets,
  O(runs) bytes; predicates run per run and expand the boolean run mask
  (`rle_cmp_mask`), values expand with a batched searchsorted-gather
  (`rle_values`), and a run-aligned filter + SUM/COUNT is O(runs)
  arithmetic (`rle_masked_sum_count`, ops/code_agg.run_space_sum_count).
- BOOLEAN_BITSET -> `BitPlate`: the packed bits, 8x fewer bytes,
  unpacked with shifts (`bit_values`).

Lanes past a batch's last run expand to the final run's value; every
consumer masks by the validity plate, so padding content is unobservable.
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
import weakref
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.utils import locks

# bind-transfer accounting: encoded bytes that crossed to the device vs the
# decoded bytes they stand for, batches whose encoded form crossed
# (batches_device_decoded) and, of those, batches that stayed code-resident
# (batches_code_bound; the port decodes a mixed column on the host, so the
# two move together)
_counters: Dict[str, int] = {"bytes_encoded": 0, "bytes_decoded_equiv": 0,
                             "batches_device_decoded": 0,
                             "batches_code_bound": 0}


# the upload stream of the calling context: None (the default) uploads
# synchronously on the current stream; the tile prefetcher's worker sets
# its own CUDA stream, and uploads then stage through pinned host memory
# and copy asynchronously on that stream
_upload_stream: contextvars.ContextVar = contextvars.ContextVar(
    "upload_stream", default=None)


@contextlib.contextmanager
def upload_scope(stream: Optional["torch.cuda.Stream"]):
    """Route this context's plate uploads onto `stream` (pinned staging,
    non_blocking copies).  The caller orders its consumers after the
    copies (an event recorded on `stream`) and marks the plates used on
    the consuming stream (`record_stream`)."""
    tok = _upload_stream.set(stream)
    try:
        if stream is None:
            yield
        else:
            with torch.cuda.stream(stream):
                yield
    finally:
        _upload_stream.reset(tok)


def upload(host_array: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array as a tensor on `device`.  Inside an upload_scope
    with a stream, the bytes stage through a pinned buffer of torch's
    caching host allocator (which keeps it alive until the copy has run)
    and copy with non_blocking=True on that stream.

    A read-only array (a memmap view of a spill or disk-tier file) is
    copied ONCE: for a CUDA target torch reads its pages directly (into
    the pinned stage, or by the pageable copy), and only a CPU target,
    whose tensor would alias the file's mapping, takes a private copy."""
    a = np.ascontiguousarray(host_array)
    if not a.flags.writeable:
        if device.type != "cuda":
            a = np.array(a)
        else:
            with warnings.catch_warnings():
                # the tensor is only ever read: as a copy source
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(a)
            return _to_device(t, device)
    return _to_device(torch.from_numpy(a), device)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    global_registry().inc("device_upload_bytes", t.numel() * t.element_size())
    if device.type == "cuda" and _upload_stream.get() is not None:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class CodePlate(NamedTuple):
    """VALUE_DICT column resident in the code domain.
    codes: [B, cap] uint8/uint16 device tensor;
    dicts: [B, D] device tensor, each row SORTED ascending and padded by
    repeating its last value (keeps searchsorted semantics exact)."""

    codes: torch.Tensor
    dicts: torch.Tensor


class RlePlate(NamedTuple):
    """RUN_LENGTH column resident as runs.
    values: [B, R] run values; ends: [B, R] int64 cumulative run end
    offsets (padded runs repeat the last end, so their length is 0)."""

    values: torch.Tensor
    ends: torch.Tensor


class BitPlate(NamedTuple):
    """BOOLEAN_BITSET column resident as packed bits [B, ceil(cap/8)]
    uint8 (LSB first, numpy packbits bitorder='little')."""

    packed: torch.Tensor


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters() -> None:
    for k in _counters:
        _counters[k] = 0


def compressed_fallback(reason: str, n: int = 1, table=None) -> None:
    """Count a decode-first reroute (a column that did NOT bind in the
    compressed domain), itemized by reason: compressed_fallback_<reason>
    plus the total.  With `table` (the ColumnTableData the reroute
    happened on) the count also lands in a per-table tally, the
    compactor's signal (storage/compact.foldable_fallbacks)."""
    reg = global_registry()
    reg.inc("compressed_fallbacks", n)
    reg.inc("compressed_fallback_" + reason, n)
    if table is not None:
        with _table_fb_lock:
            d = _table_fallbacks.setdefault(table, {})
            d[reason] = d.get(reason, 0) + n


# per-table fallback tallies: weak keys, so a dropped table takes its
# tally with it; the lock is a leaf (nothing is acquired under it)
_table_fallbacks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_table_fb_lock = locks.named_lock("storage.table_fallbacks")


def table_fallbacks(table) -> Dict[str, int]:
    """Per-table compressed-fallback counts since the last reset."""
    with _table_fb_lock:
        return dict(_table_fallbacks.get(table, ()))


def reset_table_fallbacks(table) -> None:
    """Zero a table's tally: the compactor calls this after a rewrite
    pass, so the next window measures only post-compaction reroutes."""
    with _table_fb_lock:
        _table_fallbacks.pop(table, None)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _valdict_code_dtype(vd_cols) -> np.dtype:
    """Narrowest common code dtype across the stacked batches."""
    return np.dtype(np.uint16) if any(
        c.data.dtype.itemsize > 1 for c in vd_cols) else np.dtype(np.uint8)


def code_plates(vd_cols, b: int, cap: int, dt, device: torch.device):
    """VALUE_DICT views -> a resident CodePlate plus the HOST-side sorted
    dictionary stack the bind-time batch skipper reads.

    Returns (CodePlate, host_dicts [b, Dp] float64, sizes [b] int64).
    Dictionary rows pad by REPEATING the last value so each row stays
    sorted."""
    d_pad = _next_pow2(max(1, max(len(c.dictionary) for c in vd_cols)))
    codes = np.zeros((b, cap), dtype=_valdict_code_dtype(vd_cols))
    dicts = np.zeros((b, d_pad), dtype=dt)
    host = np.zeros((b, d_pad), dtype=np.float64)
    sizes = np.zeros(b, dtype=np.int64)
    for i, c in enumerate(vd_cols):
        codes[i, :c.data.shape[0]] = c.data
        d = np.asarray(c.dictionary, dtype=dt)
        dicts[i, :d.shape[0]] = d
        host[i, :d.shape[0]] = np.asarray(c.dictionary, dtype=np.float64)
        if d.shape[0] and d.shape[0] < d_pad:
            dicts[i, d.shape[0]:] = d[-1]
            host[i, d.shape[0]:] = host[i, d.shape[0] - 1]
        sizes[i] = d.shape[0]
        _counters["bytes_encoded"] += int(c.data.nbytes + d.nbytes)
        _counters["bytes_decoded_equiv"] += int(cap * d.dtype.itemsize)
        _counters["batches_device_decoded"] += 1
        _counters["batches_code_bound"] += 1
    plate = CodePlate(upload(codes, device), upload(dicts, device))
    return plate, host, sizes


def rle_plates(rle_cols, b: int, cap: int, dt,
               device: torch.device) -> RlePlate:
    """RUN_LENGTH views -> a resident RlePlate (run values + cumulative
    end offsets, O(runs) bytes on the device instead of O(cap))."""
    r_pad = _next_pow2(max(1, max(len(c.data) for c in rle_cols)))
    vals = np.zeros((b, r_pad), dtype=dt)
    ends = np.zeros((b, r_pad), dtype=np.int64)
    for i, c in enumerate(rle_cols):
        r = len(c.data)
        vals[i, :r] = c.data
        e = np.cumsum(c.runs, dtype=np.int64)
        ends[i, :r] = e
        if r and r < r_pad:
            vals[i, r:] = vals[i, r - 1]
            ends[i, r:] = e[-1]
        _counters["bytes_encoded"] += int(
            c.data.nbytes + np.asarray(c.runs).nbytes)
        _counters["bytes_decoded_equiv"] += int(cap * vals.dtype.itemsize)
        _counters["batches_device_decoded"] += 1
        _counters["batches_code_bound"] += 1
    return RlePlate(upload(vals, device), upload(ends, device))


def bit_plates(bit_cols, b: int, cap: int, device: torch.device) -> BitPlate:
    """BOOLEAN_BITSET views -> a resident BitPlate (8x fewer bytes)."""
    nbytes = (cap + 7) // 8
    packed = np.zeros((b, nbytes), dtype=np.uint8)
    for i, c in enumerate(bit_cols):
        raw = np.asarray(c.data, dtype=np.uint8)
        packed[i, :raw.shape[0]] = raw
        _counters["bytes_encoded"] += int(raw.nbytes)
        _counters["bytes_decoded_equiv"] += int(cap)
        _counters["batches_device_decoded"] += 1
        _counters["batches_code_bound"] += 1
    return BitPlate(upload(packed, device))


def rle_expand_runs(run_array: torch.Tensor, ends: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """Expand any per-run [B, R] array (values, boolean run masks) to row
    space [B, cap]: lane j takes the run whose half-open [prev_end, end)
    interval holds j (a batched searchsorted-gather)."""
    pos = torch.arange(cap, dtype=ends.dtype, device=ends.device)
    seg = torch.searchsorted(ends.contiguous(),
                             pos.expand(ends.shape[0], cap).contiguous(),
                             right=True)
    seg = seg.clamp(max=run_array.shape[1] - 1)
    return torch.gather(run_array, 1, seg)


def rle_values(plate: RlePlate, cap: int) -> torch.Tensor:
    """Lazy expansion of an RlePlate to [B, cap] values."""
    return rle_expand_runs(plate.values, plate.ends, cap)


def bit_values(plate: BitPlate, cap: int) -> torch.Tensor:
    """Lazy unpack of a BitPlate to [B, cap] bools."""
    idx = torch.arange(cap, device=plate.packed.device)
    byte = plate.packed[:, idx // 8]
    shift = (idx % 8).to(torch.uint8)
    return torch.bitwise_and(torch.bitwise_right_shift(byte, shift),
                             1).bool()


def rle_cmp_mask(fn, plate: RlePlate, lit, cap: int) -> torch.Tensor:
    """Run-arithmetic filter over an RlePlate: the predicate runs per RUN
    (O(runs) compares) and the boolean run mask expands — the full-width
    value plate is never produced."""
    return rle_expand_runs(fn(plate.values, lit), plate.ends, cap)


def rle_run_lengths(ends: torch.Tensor) -> torch.Tensor:
    """Per-run lengths from cumulative end offsets (padded runs repeat
    the last end, so their length is exactly 0)."""
    prev = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    return ends - prev


def rle_masked_sum_count(plate: RlePlate, run_mask: torch.Tensor):
    """O(runs) filter + aggregate arithmetic: with a per-run boolean
    mask, count = sum(len * mask) and sum = sum(value * len * mask) in
    float64.  Valid only when the surviving row set is run-aligned (no
    row-level holes inside runs)."""
    lens = rle_run_lengths(plate.ends)
    lm = torch.where(run_mask, lens, torch.zeros_like(lens))
    return (plate.values.to(torch.float64) * lm).sum(), \
        lm.sum().to(torch.int64)


def code_values(plate: CodePlate) -> torch.Tensor:
    """Lazy decode of a CodePlate: one per-batch dictionary gather."""
    return torch.gather(plate.dicts, 1, plate.codes.long())


def promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """Binary-operation dtype of two STRONGLY typed operands, the way the
    reference's jnp operations promote: a float meets an int at the float
    type, two floats (or two ints) at the wider one.  torch's own rule
    lets a 0-dim operand's width lose to a dimensioned operand's, which
    would change comparisons against wide literals."""
    if a == b:
        return a
    if a == torch.bool:
        return b
    if b == torch.bool:
        return a
    af, bf = a.is_floating_point, b.is_floating_point
    if af != bf:
        return a if af else b
    return torch.promote_types(a, b)


def code_cmp_mask(op: str, plate: CodePlate, lit: torch.Tensor
                  ) -> torch.Tensor:
    """Code-domain lowering of `column OP literal` over a CodePlate: the
    literal translates to per-batch code thresholds through the SORTED
    dictionaries (one searchsorted per batch) and the comparison runs on
    the small integer codes — the decoded plate never materializes.

    The dictionary and the literal are promoted to their common compare
    dtype first, so boundary behavior is bit-identical to comparing the
    decoded values.  Out-of-dictionary equality literals match nothing;
    NaN literals follow IEEE semantics."""
    codes = plate.codes.int()
    cd = promote(plate.dicts.dtype, lit.dtype)
    d = plate.dicts.to(cd).contiguous()
    v = lit.to(cd).reshape(1, 1).expand(d.shape[0], 1).contiguous()
    if op in ("=", "!="):
        pos = torch.searchsorted(d, v, side="left")
        posc = pos.clamp(0, d.shape[1] - 1)
        hit = torch.gather(d, 1, posc)[:, 0] == v[:, 0]
        code_eq = torch.where(hit, posc[:, 0].int(),
                              torch.full_like(posc[:, 0].int(), -1))
        return codes == code_eq[:, None] if op == "=" \
            else codes != code_eq[:, None]
    # values >= lit  <=>  code >= searchsorted(dict, lit, left); the
    # right-side variants shift the threshold past equal values
    side = "left" if op in (">=", "<") else "right"
    pos = torch.searchsorted(d, v, side=side)[:, 0].int()
    m = codes >= pos[:, None] if op in (">=", ">") \
        else codes < pos[:, None]
    if op in ("<", "<=") and cd.is_floating_point:
        # x < NaN is False, but NaN sorts past every dictionary entry
        # (threshold = D -> all codes pass): guard explicitly
        m = m & ~torch.isnan(lit.to(cd))
    return m
