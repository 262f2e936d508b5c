"""Device join primitives: key encoding, cached build artifacts,
one-to-many expansion.

Port of snappydata_tpu/ops/join.py.  The device join is sort +
searchsorted (ref: HashJoinExec keeping replicated/collocated joins
shuffle-free): build keys sort once, every probe row binary-searches its
match RANGE.  This module holds the pieces the executor's join emitter
composes:

- **Key encoding** (`key_bits` / `combine_key_arrays` /
  `encode_build_keys`): the single int64 key domain both sides compare
  in, bit-identical to the reference's.  The multi-key hash is the
  reference's uint64 mix computed in int64: wrapping multiplication gives
  the same bits, and a logical right shift masks off the sign extension.
  The executor's generic group-key lane delegates here too, so the
  domains never drift.

- **Build artifact cache** (`build_artifact`): sorted keys + stable sort
  order + joint-key uniqueness per (bind identity, key ordinals/encode
  signature), LRU byte-capped by `join_build_cache_bytes`: repeated joins
  skip the per-execution sort (`join_build_sorts` stays O(1) per
  build-side version).  Bind identity is the DeviceTable's `valid`
  tensor, which the plate cache rotates on every mutation, so entries
  invalidate with no version plumbing.

- **Expansion bound** (`probe_expand_bound`): bind-time upper bound on
  the expanded output size, summed over the UNFILTERED probe leaf (query
  filters only shrink validity, so the bound is sound), memoized on the
  artifact per probe bind identity and probe key ordinals.

- **One-to-many expansion** (`expand`): prefix-summed match counts map a
  `{2^k, 1.5*2^k}`-bucketed output axis back to (probe row, k-th passing
  build row) pairs with two searchsorteds.

- **String-key translation** (`translate_codes`): left dictionary codes
  mapped into the right table's code space via one vectorized
  np.searchsorted, cached per (left-dict version, right-dict version) —
  dictionaries are append-only, so their LENGTH is the version token.

Every primitive is a stable sort, a searchsorted, a cumsum or an index
gather: the reference computes them outside any Pallas kernel, and here
they stay torch ops.
"""

from __future__ import annotations

import weakref
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
# the expanded-output axis reuses the batch axis' two-shapes-per-octave
# bucketing ({2^k, 1.5*2^k}) — one policy for both
from snappydata_tpu_torch.storage.device import batch_bucket as expand_bucket
from snappydata_tpu_torch.utils import locks

I64_MAX = np.iinfo(np.int64).max
# Build-side NULL keys and dead/padded rows collapse into this sentinel
# (sorts to the end, excluded from uniqueness); probe-side NULL keys get
# a DISTINCT sentinel so they can never match it.  A real key hitting
# either exact bit pattern is the documented ~2^-63 collision caveat.
BUILD_NULL_SENTINEL = I64_MAX
PROBE_NULL_SENTINEL = I64_MAX - 7


def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


_MIX1 = _i64(0xbf58476d1ce4e5b9)
_MIX2 = _i64(0x94d049bb133111eb)
_FNV = 0x100000001b3


def _shr(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (k >> s) & ((1 << (64 - s)) - 1)


# --- key encoding ---------------------------------------------------------

def key_bits(v: torch.Tensor) -> torch.Tensor:
    """Exact int64 representation of a join/grouping key: floats BITCAST
    (a plain cast truncated 2.1 and 2.9 both to 2), with +/-0.0
    normalized so they compare equal."""
    if v.is_floating_point():
        v = torch.where(v == 0, torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)
        if v.dtype == torch.float64:
            return v.contiguous().view(torch.int64)
        return v.to(torch.float32).contiguous().view(torch.int32) \
            .to(torch.int64)
    return v.to(torch.int64)


def combine_key_arrays(pairs: List[Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]]
                       ) -> torch.Tensor:
    """Combine N (value, null-or-None) key columns into one int64 key.
    Single key: exact (NULL maps to a reserved sentinel).  Multiple:
    64-bit hash with the null flag folded in exactly (collision risk
    ~ n^2 * 2^-64, same contract as the aggregate's combined key).  The
    caller overrides any-null rows with the side's sentinel afterwards,
    so the single/multi null encodings never need to agree."""
    if len(pairs) == 1:
        v, nl = pairs[0]
        bits = key_bits(v)
        if nl is not None:
            bits = torch.where(nl, I64_MAX - 1, bits)
        return bits
    acc = torch.zeros(pairs[0][0].shape, dtype=torch.int64,
                      device=pairs[0][0].device)
    for v, nl in pairs:
        k = key_bits(v)
        k = (k ^ _shr(k, 30)) * _MIX1
        k = (k ^ _shr(k, 27)) * _MIX2
        k = k ^ _shr(k, 31)
        acc = acc * _FNV + k
        if nl is not None:
            acc = acc * 2 + nl.to(torch.int64)
    return acc


def encode_probe_keys(pairs, null_flat) -> torch.Tensor:
    """Flat probe keys with NULLs sentineled (NULL keys never match —
    SQL semantics).  Structurally-invalid probe rows keep their raw key;
    the caller masks their match COUNTS instead."""
    keys = combine_key_arrays(pairs).reshape(-1)
    if null_flat is not None:
        keys = torch.where(null_flat, PROBE_NULL_SENTINEL, keys)
    return keys


def encode_build_keys(pairs, valid_flat, null_flat) -> torch.Tensor:
    """Flat build keys with NULL keys AND dead/padded rows collapsed
    into the build sentinel (sorts to the end, matches nothing)."""
    keys = combine_key_arrays(pairs).reshape(-1)
    keep = valid_flat if null_flat is None else (valid_flat & ~null_flat)
    return torch.where(keep, keys, BUILD_NULL_SENTINEL)


# --- build artifact cache -------------------------------------------------

_CACHE_LOCK = locks.named_lock("join.build_cache")
_BUILD_CACHE: dict = {}      # (id(ident), token) -> entry
_BUILD_BYTES = [0]
_tick = [0]


def _next_tick() -> int:
    _tick[0] += 1
    return _tick[0]


def join_build_cache_nbytes() -> int:
    """Bytes of device tensors pinned by the build-artifact cache."""
    return int(_BUILD_BYTES[0])


def clear_join_caches() -> None:
    with _CACHE_LOCK:
        _BUILD_CACHE.clear()
        _BUILD_BYTES[0] = 0
        _TRANS_CACHE.clear()


def build_artifact(ident, token, compute: Callable[[], torch.Tensor]
                   ) -> dict:
    """Sorted-build artifact for one (bind identity, key signature).

    `ident` is the build DeviceTable's `valid` tensor — reused across
    binds while the snapshot is current, rotated by mutations, so it
    invalidates entries without explicit versions.  `compute()` returns
    the flat sentineled build keys; runs only on a miss.  Returns
    {"skeys", "order", "unique", "nbytes", ...}: the sort is STABLE, so
    equal keys keep their flat order, as the reference's argsort does."""
    reg = global_registry()
    budget = int(config.global_properties().join_build_cache_bytes or 0)
    key = (id(ident), token)
    with _CACHE_LOCK:
        e = _BUILD_CACHE.get(key)
        if e is not None:
            if e["ident"]() is ident:
                e["tick"] = _next_tick()
                reg.inc("join_build_cache_hits")
                return e
            # id() reuse after GC: the weakref proves staleness
            _BUILD_BYTES[0] -= _BUILD_CACHE.pop(key)["nbytes"]
    reg.inc("join_build_cache_misses")
    bkeys = compute()
    skeys, order = torch.sort(bkeys, stable=True)
    if skeys.shape[0] > 1:
        dup = torch.any((skeys[1:] == skeys[:-1])
                        & (skeys[:-1] != BUILD_NULL_SENTINEL))
        unique = not bool(dup)
    else:
        unique = True
    reg.inc("join_build_sorts")
    entry = {"skeys": skeys, "order": order, "unique": unique,
             "nbytes": int(skeys.nbytes) + int(order.nbytes),
             "ident": weakref.ref(ident), "tick": _next_tick(),
             "bounds": {}}
    if budget <= 0 or entry["nbytes"] > budget:
        return entry  # uncached: every bind of this shape re-sorts
    with _CACHE_LOCK:
        # purge entries whose bind identity was collected (table mutated
        # or dropped — the old device tensors are gone)
        for k in [k for k, e2 in _BUILD_CACHE.items()
                  if e2["ident"]() is None]:
            _BUILD_BYTES[0] -= _BUILD_CACHE.pop(k)["nbytes"]
        while _BUILD_CACHE and _BUILD_BYTES[0] + entry["nbytes"] > budget:
            victim = min(_BUILD_CACHE, key=lambda k: _BUILD_CACHE[k]["tick"])
            _BUILD_BYTES[0] -= _BUILD_CACHE.pop(victim)["nbytes"]
        old = _BUILD_CACHE.pop(key, None)
        if old is not None:  # concurrent miss on one key: replace once
            _BUILD_BYTES[0] -= old["nbytes"]
        _BUILD_CACHE[key] = entry
        _BUILD_BYTES[0] += entry["nbytes"]
    return entry


def probe_expand_bound(artifact: dict, probe_ident, probe_token,
                       null_extend: bool,
                       compute_pkeys: Callable[[], tuple]) -> int:
    """Upper bound on the expanded output rows for (probe bind, build
    artifact): per-probe match-range widths over the UNFILTERED probe
    leaf summed, plus one slot per probe row when the join NULL-extends
    unmatched probe rows (left/full).  Query filters only shrink the
    validity, so the bound is sound.  Memoized ON the artifact entry
    keyed by (probe bind identity, `probe_token`) — the token carries the
    probe KEY ordinals, so two queries probing the same snapshot on
    different columns never share a bound; a probe mutation rotates the
    identity, an artifact invalidation drops the memo."""
    key = (id(probe_ident), probe_token, bool(null_extend))
    with _CACHE_LOCK:
        hit = artifact["bounds"].get(key)
        if hit is not None and hit[0]() is probe_ident:
            return hit[1]
    pkeys, valid_flat = compute_pkeys()
    counts, _lo = match_ranges_dense(artifact["skeys"], pkeys)
    total = torch.where(valid_flat, counts, 0).sum()
    if null_extend:
        total = total + valid_flat.sum()
    bound = int(total)
    with _CACHE_LOCK:
        if len(artifact["bounds"]) > 64:
            artifact["bounds"].clear()
        artifact["bounds"][key] = (weakref.ref(probe_ident), bound)
    return bound


# --- per-execution expansion ----------------------------------------------
# Two range flavors:
#   dense      — the build has NO query filter.  Dead/padded and NULL-key
#                rows are already key-sentineled by the artifact encode
#                and sort to the END, so every row inside a real key's
#                [lo, hi) run is live: counts come straight from the
#                searchsorted bounds and the k-th match is order[lo + k].
#                This is the hot Q3-class shape.
#   pass-aware — a WHERE applies to the build side.  A prefix sum over
#                the sorted pass mask counts the PASSING rows of each
#                range, and the k-th passing row is located with one more
#                searchsorted into that prefix sum.

def match_ranges_dense(skeys: torch.Tensor, pkeys: torch.Tensor):
    """(counts, lo) per probe key against an unfiltered sorted build;
    `lo` is in the sorted POSITION domain (k-th match at order[lo+k])."""
    pk = pkeys.contiguous()
    lo = torch.searchsorted(skeys, pk)
    hi = torch.searchsorted(skeys, pk, right=True)
    return hi - lo, lo


def match_ranges(skeys, order, pass_flat, pkeys):
    """Pass-aware flavor: returns (counts, base, cum) where `counts[p]`
    is the number of PASSING build rows whose key equals `pkeys[p]`,
    `base[p]` the count of passing rows strictly before the range, and
    `cum` the inclusive prefix-sum of the sorted pass mask (the index
    `nth_match` uses to locate the k-th passing row)."""
    cum = torch.cumsum(pass_flat[order].to(torch.int64), 0)
    pk = pkeys.contiguous()
    lo = torch.searchsorted(skeys, pk)
    hi = torch.searchsorted(skeys, pk, right=True)
    base = torch.where(lo > 0, cum[(lo - 1).clamp(min=0)], 0)
    top = torch.where(hi > 0, cum[(hi - 1).clamp(min=0)], 0)
    return top - base, base, cum


def nth_match(base, rank, cum, order):
    """Flat build position of the (rank+1)-th PASSING row of a match
    range (garbage when the range has fewer passing rows — callers mask
    with their `matched` flag)."""
    maxc = torch.clamp(cum[-1], min=1)
    target = torch.minimum(torch.clamp(base + rank + 1, min=1), maxc)
    pos = torch.searchsorted(cum, target.contiguous())
    return order[pos.clamp(0, cum.shape[0] - 1)]


def nth_match_dense(base, rank, order):
    """Dense flavor: the k-th match of a range starting at sorted
    position `base` is simply order[base + k]."""
    return order[(base + rank).clamp(0, order.shape[0] - 1)]


def expand(counts, counts_eff, bucket: int):
    """Static-shape one-to-many expansion bookkeeping.

    `counts_eff` is counts with the NULL-extension floor already applied
    (left/full: max(counts, 1) on valid probe rows; invalid rows 0).
    Returns (probe_of, rank, matched, slot_valid, total_real) — all
    [bucket] except the 0-dim total; `matched` false on a slot means its
    probe row NULL-extends (no passing build row).  The caller maps
    (probe_of, rank) to a build position with nth_match[_dense]."""
    cumc = torch.cumsum(counts_eff, 0)
    total = cumc[-1]
    out_idx = torch.arange(bucket, dtype=torch.int64, device=cumc.device)
    probe_of = torch.searchsorted(cumc, out_idx, right=True)
    probe_of.clamp_(0, counts_eff.shape[0] - 1)
    # rank = out_idx - (cumc - counts_eff)[probe_of], built in place: at
    # the join path's sizes every [bucket] int64 temporary is ~1 GB
    rank = cumc[probe_of]
    rank.sub_(counts_eff[probe_of]).neg_().add_(out_idx)
    slot_valid = out_idx < total
    del out_idx
    matched = slot_valid & (rank < counts[probe_of])
    return probe_of, rank, matched, slot_valid, total


# --- string-key translation LUT -------------------------------------------

_TRANS_CACHE: dict = {}   # cache_key -> (owner weakrefs, trans array)


def translate_codes(ld: np.ndarray, rd: np.ndarray,
                    cache_key=None, owners=None) -> np.ndarray:
    """Left-dictionary codes -> right-table code space (-1 = no such
    value, which equals no real code), padded to a pow2 size so the LUT
    shape is stable as dictionaries grow within an octave.

    Vectorized: one np.searchsorted over the sorted right dictionary.
    `cache_key` (when the caller can prove both dictionaries are
    base-table dictionaries) keys a process-wide memo; append-only
    dictionaries make their length the version, so the key embeds both
    lengths.  `owners` are the two owning table-data objects —
    weakref-validated so an id() reused by a recreated table can never
    serve a stale LUT."""
    key = None
    if cache_key is not None and owners is not None:
        key = cache_key + (len(ld), len(rd))
        with _CACHE_LOCK:
            hit = _TRANS_CACHE.get(key)
            if hit is not None:
                refs, trans = hit
                if all(r() is o for r, o in zip(refs, owners)):
                    global_registry().inc("join_trans_cache_hits")
                    return trans
                _TRANS_CACHE.pop(key, None)
    n = len(ld)
    if n == 0 or len(rd) == 0:
        trans = np.full(n, -1, dtype=np.int32)
    else:
        lvals = np.asarray([v if v is not None else "" for v in ld.tolist()],
                           dtype=np.str_)
        rvals = np.asarray([v if v is not None else "" for v in rd.tolist()],
                           dtype=np.str_)
        rorder = np.argsort(rvals, kind="stable")
        rs = rvals[rorder]
        pos = np.searchsorted(rs, lvals)
        posc = np.minimum(pos, len(rs) - 1)
        trans = np.where(rs[posc] == lvals, rorder[posc], -1) \
            .astype(np.int32)
    size = max(1, 1 << (max(1, n) - 1).bit_length())
    if size > n:
        trans = np.concatenate(
            [trans, np.full(size - n, -1, dtype=np.int32)])
    if key is not None:
        with _CACHE_LOCK:
            if len(_TRANS_CACHE) > 512:
                _TRANS_CACHE.clear()
            _TRANS_CACHE[key] = (tuple(weakref.ref(o) for o in owners),
                                 trans)
    return trans
