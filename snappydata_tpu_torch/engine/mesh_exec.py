"""Mesh-sharded execution of compile-once partial-aggregate programs.

Port of snappydata_tpu/engine/mesh_exec.py.  With a slot mesh active
(parallel/mesh.py), a tilable aggregate shape — single-relation scans
(Q1 / Q6) and probe-leftmost join trees (Q3C) — runs its PARTIAL program
(the decomposition the tiled scan already compiles once) once per slot:
every slot scans only its block of the still-ENCODED plates, computes the
group index in the shared [G] space (dictionary codes are table-global,
so a per-slot group index needs no coordination) and reduces its [G]
partials through the same kernels a single-device run launches.  The
partials then merge on slot 0's device: sums (counts and sums of squares
too) add in float64, minima and maxima fold, the masks and the overflow
flags OR — the reference's in-trace `psum` / `pmin` / `pmax` under
`shard_map`, and its partial aggregation + CollectAggregateExec merge
(SnappyStrategies.scala:347).  Every slot runs, as the reference's do:
a slot whose block holds only padded batches adds the merge's identity.

Joins pick a distribution strategy per bind, counted like the join
engine's fallback reasons:

* **broadcast-build** — every slot probes the FULL build side: on the
  home device it is the same tensors (a shared reference), on another
  card one cached copy per card (ref: replicated-table HashJoinExec
  build broadcast, joins/HashJoinExec.scala:63).
* **shuffle-on-key** — both sides are exchanged BUCKET-WISE on the join
  key: the encoded int64 key domain (shared by both sides — string codes
  translate first) hashes through parallel/hashing's murmur3 into one
  bucket per slot, and each side's rows re-lay out so slot d holds
  exactly bucket d of both sides.  Matching keys are then collocated,
  each slot sorts its LOCAL build slice in the emitter (the `shuf_si`
  static specialization in the executor's join), and no row crosses a
  slot during execution.  The exchange is one gather per plate, CACHED
  per (bind identity, mesh, params), so repeated executions of an
  unchanged table re-exchange nothing.

Everything this lane cannot express falls back to the single-device
program over the whole plates on the home device (the counterpart of the
reference's plain GSPMD jit over the sharded bind), counted
`mesh_fallback_<reason>` by the session.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time
import weakref
from typing import Dict, Optional, Tuple

import torch

from snappydata_tpu_torch.utils import locks

# -- shuffle specialization flag ------------------------------------------
# Read by the executor's join (its shuffle static provider and artifact
# aux builder) during a bind this module drives; a contextvar so
# concurrent sessions on other threads bind unaffected.

_shuffle_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "mesh_shuffle", default=False)
# set to the slot count while THIS module drives a bind (both
# strategies): the join's mode provider sizes the expansion bucket per
# slot — each slot expands only its probe block
_bind_devices: contextvars.ContextVar = contextvars.ContextVar(
    "mesh_bind_devices", default=0)

_cache_lock = locks.named_lock("engine.mesh_exec")


def shuffle_active() -> bool:
    return bool(_shuffle_ctx.get())


def bind_devices() -> int:
    """Slot count of the mesh-lane bind in flight on this thread (0 = not
    a mesh-lane bind)."""
    return int(_bind_devices.get())


def _reg():
    from snappydata_tpu_torch.observability.metrics import global_registry

    return global_registry()


# -- strategy selection ----------------------------------------------------

def choose_join_strategy(compiled, build_bytes: int,
                         probe_data) -> Tuple[str, Optional[str]]:
    """('broadcast'|'shuffle', decline_reason_or_None).

    The decline reason says why AUTO (or a forced 'shuffle') could not
    shuffle and fell back to broadcast — counted
    mesh_join_shuffle_fallback_<reason> by the caller."""
    from snappydata_tpu_torch import config

    props = config.global_properties()
    knob = str(props.get("mesh_join_strategy", "auto") or "auto").lower()
    if not compiled.join_meta:
        return "broadcast", None
    if knob == "broadcast":
        return "broadcast", None
    reason = _shuffle_ineligible(compiled, probe_data)
    if knob == "shuffle":
        return ("broadcast", reason) if reason else ("shuffle", None)
    # auto: broadcast small builds (one shared or copied build side per
    # card and the artifact fast path); shuffle once the replicated build
    # would dominate per-card memory
    limit = int(props.get("mesh_broadcast_build_bytes", 64 << 20) or 0)
    if limit and build_bytes > limit:
        return ("broadcast", reason) if reason else ("shuffle", None)
    return "broadcast", None


def _shuffle_ineligible(compiled, probe_data) -> Optional[str]:
    if len(compiled.join_meta) != 1:
        return "multi_join"
    meta = compiled.join_meta[0]
    if not meta["artifact_mode"] or meta["shuf_si"] is None:
        return "derived_build"
    if meta["probe_rel"] is None or meta["probe_ords"] is None:
        return "derived_probe"
    if meta["probe_rel"].info.data is not probe_data:
        return "probe_mismatch"
    if meta["how"] not in ("inner", "left", "semi", "anti"):
        return "outer_extension"
    return None


# -- bind-side helpers -----------------------------------------------------

class _Ineligible(Exception):
    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


def _rel_index(compiled, rel) -> int:
    return next(i for i, r in enumerate(compiled.relations) if r is rel)


def _encoded_keys(compiled, meta, side: str, rels) -> Tuple:
    """(flat int64 encoded keys, flat valid) of one join side of the
    CURRENT bind — the exact key domain the emitter compares in (string
    codes translated to the build's code space, f64 pairs cast), so the
    bucket placement and the per-slot matching agree bit for bit."""
    from snappydata_tpu_torch.ops import join as _dj

    rel = meta["probe_rel"] if side == "probe" else meta["build_rel"]
    ords = meta["probe_ords"] if side == "probe" else meta["build_ords"]
    cols, valid = rels[_rel_index(compiled, rel)]
    pairs = []
    anynull = None
    for pi, (ci, spec) in enumerate(zip(ords, meta["enc_spec"])):
        v, nl = cols[ci]
        if isinstance(v, tuple):
            raise _Ineligible("complex_plate")
        v = v.reshape(-1)
        nl = nl.reshape(-1) if nl is not None else None
        if side == "probe":
            getter = meta["trans_getters"].get(pi)
            if getter is not None:
                trans = torch.from_numpy(getter()).to(v.device)
                v = trans[v.long().clamp(0, trans.shape[0] - 1)]
        if spec == "f64":
            v = v.to(torch.float64)
        pairs.append((v, nl))
        if nl is not None:
            anynull = nl if anynull is None else (anynull | nl)
    valid_flat = valid.reshape(-1)
    if side == "probe":
        keys = _dj.encode_probe_keys(pairs, anynull)
    else:
        keys = _dj.encode_build_keys(pairs, valid_flat, anynull)
    return keys, valid_flat


def _bucket_layout(keys: torch.Tensor, valid: torch.Tensor, cap: int,
                   nd: int, old_batches: int):
    """Bucket-wise exchange plan for one side, on the keys' device: live
    rows hash into `nd` buckets over the encoded key domain
    (Spark-compatible murmur3 — parallel/hashing), bucket d's rows pack,
    in row order, into slot d's block.  Returns (perm [B_new*cap] source
    flat indices, live mask, B_new, moved_rows) — the reference's host
    layout (snappydata_tpu/engine/mesh_exec.py `_bucket_layout`), built
    with a stable sort instead of one mask per bucket."""
    from snappydata_tpu_torch.parallel.hashing import bucket_of_torch
    from snappydata_tpu_torch.parallel.mesh import _ladder

    dev = keys.device
    live_idx = torch.nonzero(valid).reshape(-1)
    buckets = bucket_of_torch(keys[live_idx], nd)
    bsorted, order = torch.sort(buckets, stable=True)
    rows = live_idx[order]
    counts = torch.bincount(buckets, minlength=nd)
    max_rows = int(counts.max()) if rows.numel() else 0
    s_batches = _ladder(max(1, -(-max_rows // cap)))
    b_new = nd * s_batches
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.numel(), device=dev) - starts[bsorted]
    dest = bsorted * (s_batches * cap) + rank
    perm = torch.zeros(b_new * cap, dtype=torch.int64, device=dev)
    perm[dest] = rows
    live = torch.zeros(b_new * cap, dtype=torch.bool, device=dev)
    live[dest] = True
    # a row "moves" when its source slot block differs from its bucket's
    # owner — the exchange evidence
    src_dev = (rows // cap) * nd // max(1, old_batches)
    moved = int((src_dev != bsorted).sum())
    return perm, live, b_new, moved


def _exchange_relation(rel_in, perm, live, b_new, cap):
    """Re-lay one relation's bound plates bucket-wise: one gather per
    plate into a fresh [B_new, cap] layout on the home device, whose slot
    blocks are the buckets.  Returns ((cols, valid), exchanged_bytes)."""
    cols, valid = rel_in
    live2 = live.reshape(b_new, cap)

    def gather(x):
        return x.reshape(-1)[perm].reshape(b_new, cap)

    out: Dict[int, tuple] = {}
    nbytes = 0
    for ci, (v, nl) in cols.items():
        if isinstance(v, tuple):
            raise _Ineligible("complex_plate")
        v2 = gather(v)
        nl2 = gather(nl) if nl is not None else None
        nbytes += _nbytes(v2) + _nbytes(nl2)
        out[ci] = (v2, nl2)
    valid2 = gather(valid) & live2
    nbytes += _nbytes(valid2)
    return (out, valid2), nbytes


def _nbytes(x) -> int:
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def _to(x, dev: torch.device, keep: bool = False):
    """`x` (a tensor, or tuples / dicts of them) on `dev`; `keep` reuses
    one copy a tensor while it lives (`parallel.mesh.remote_copy`)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if x.device == dev:
            return x
        if keep:
            from snappydata_tpu_torch.parallel.mesh import remote_copy

            return remote_copy(x, dev)
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev, keep) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [_to(v, dev, keep) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    if isinstance(x, list):
        return [_to(v, dev, keep) for v in x]
    return x


# -- the lane --------------------------------------------------------------

def run_partial(compiled, params: Tuple, probe_data, ctx,
                build_bytes: int = 0):
    """Bind a partial-raw compiled plan over the active mesh, run its
    emitter once per slot and merge the slots' [G] partials; returns
    the host (mask, pairs) ready for compiled._assemble.
    Raises CompileError when a slot's overflow flag is set (group
    cardinality or join expansion past its bound): the caller falls back
    to the single-device program, counted."""
    from snappydata_tpu_torch.engine.exprs import CompileError
    from snappydata_tpu_torch.observability import tracing
    from snappydata_tpu_torch.parallel.mesh import (block_copies,
                                                    dispatch_lock)
    from snappydata_tpu_torch.reliability import failpoints as rfail

    reg = _reg()
    strategy, decline = ("scan", None) if not compiled.join_meta else \
        choose_join_strategy(compiled, build_bytes, probe_data)
    if decline:
        reg.inc("mesh_join_shuffle_fallback_" + decline)
    home = ctx.home

    def _bind_with(strat):
        tok = _shuffle_ctx.set(strat == "shuffle")
        tok_d = _bind_devices.set(ctx.num_devices)
        try:
            return compiled._bind(params, home)
        finally:
            _shuffle_ctx.reset(tok)
            _bind_devices.reset(tok_d)

    probe_rels = {i for i, r in enumerate(compiled.relations)
                  if r.info.data is probe_data}
    try:
        rels, aux, static, _pvals = _bind_with(strategy)
        tables = [r.bound() for r in compiled.relations]
        sharded = set(probe_rels)
        if strategy == "shuffle":
            try:
                meta = compiled.join_meta[0]
                rels = _apply_shuffle(compiled, meta, rels, tables, static,
                                      params, ctx, reg)
                sharded.add(_rel_index(compiled, meta["build_rel"]))
                reg.inc("mesh_join_shuffle")
            except _Ineligible as e:
                # an exchange-time ineligibility (a complex plate on a
                # join side) DECLINES TO BROADCAST like the plan-time
                # checks; the bind re-runs with the shuffle
                # specialization off
                reg.inc("mesh_join_shuffle_fallback_" + e.reason)
                strategy = "broadcast"
                rels, aux, static, _pvals = _bind_with(strategy)
                tables = [r.bound() for r in compiled.relations]
                sharded = set(probe_rels)
        copies: Dict = {}
        if strategy == "broadcast":
            copies = _apply_broadcast(compiled, rels, sharded, tables,
                                      static, params, ctx, reg)
            reg.inc("mesh_join_broadcast")

        tags = compiled.tile_merge["tags"]
        n_merges = sum(1 for t in tags if t[0] != "key")
        span = compiled._span_name((static, "mesh", ctx.num_devices,
                                    strategy))
        # mesh_dispatch entry seam — before the leaf lock, so an injected
        # raise fails the statement before any slot runs
        rfail.hit("mesh.dispatch")
        copies0 = block_copies()
        with tracing.span(span, phase="mesh", devices=ctx.num_devices), \
                dispatch_lock:
            outs = [_run_slot(compiled, ctx, i, rels, aux, static, params,
                              sharded, copies)
                    for i in range(ctx.num_devices)]
            merged = merge_slot_outs(outs, tags, home)
            if home.type == "cuda":
                # locklint: blocking-under-lock the dispatch fence must
                # cover the slots' runs to their completion
                torch.cuda.synchronize(home)
    finally:
        for r in compiled.relations:
            r.unbind()
    reg.inc("mesh_shard_execs")
    reg.inc("mesh_psum_merges", n_merges)
    if block_copies() != copies0:
        reg.inc("mesh_block_copies", block_copies() - copies0)
    compiled._count_agg_notes(static)
    mask, pairs, overflow = merged
    if overflow is not None and bool(overflow):
        raise CompileError(
            "mesh partial overflow (group cardinality or join expansion "
            "past its bound): single-device path")
    with tracing.span("transfer"):
        return compiled._to_host(mask, pairs)


def _run_slot(compiled, ctx, i: int, rels, aux, static, params, sharded,
              copies):
    """The emitter over slot i's block of the sharded relations and the
    whole replicated ones, on slot i's device: (mask, pairs, overflow)."""
    from snappydata_tpu_torch.engine.executor import _DeviceParams, _RunCtx

    dev = ctx.mesh.slots[i].device
    rels_i = []
    for ri, (cols, valid) in enumerate(rels):
        if ri in sharded:
            b = int(valid.shape[0])
            rels_i.append(({ci: (ctx.block(v, i, b), ctx.block(nl, i, b))
                            for ci, (v, nl) in cols.items()},
                           ctx.block(valid, i, b)))
        elif valid.device == dev:
            rels_i.append((cols, valid))
        else:
            rels_i.append(copies[(ri, str(dev))])
    aux_i = aux if dev == ctx.home else _to(list(aux), dev, keep=True)
    run_ctx = _RunCtx(compiled.relations, rels_i, aux_i,
                      _DeviceParams(params, dev), static, dev)
    # the slot's card is the current one while its kernels launch (a
    # wrapper launches on the current device's context)
    with torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext():
        mask, pairs = compiled._noted_call(static, "mesh",
                                           compiled.emitter, (run_ctx,))
    return mask, pairs, run_ctx.overflow


def merge_slot_outs(outs, tags, home: torch.device):
    """Merge the slots' raw (mask, pairs, overflow) partials over their
    ALIGNED [G] space on the home device, slot by slot in slot order,
    through the tiled lane's merge (`merge_tile_outs`): sum-family slots
    add (their partials are float64, or int64 counts), min / max fold,
    keys come from slot 0, the masks and overflow flags OR — the
    reference's psum / pmin / pmax / psum(mask) > 0."""
    from snappydata_tpu_torch.engine.executor import merge_tile_outs

    merged = _to(outs[0], home)
    for out in outs[1:]:
        merged = merge_tile_outs(merged, _to(out, home), tags)
    return merged


# -- shuffle / broadcast layout caches -------------------------------------
# Keyed on (mesh token, static, bind identity, params): an unchanged
# table version re-uses the exchanged layout; a mutation rotates the bind
# identity (the per-version `valid` tensor) and the entry ages out.  The
# per-plan caches register in a WeakKeyDictionary so the byte gauge WALKS
# live entries instead of keeping a counter ledger.

_LAYOUT_CACHES = weakref.WeakKeyDictionary()


def _layout_cache(compiled) -> "collections.OrderedDict":
    with _cache_lock:
        cache = _LAYOUT_CACHES.get(compiled)
        if cache is None:
            cache = collections.OrderedDict()
            _LAYOUT_CACHES[compiled] = cache
    return cache


def mesh_layout_cache_nbytes() -> int:
    """Device bytes the exchanged and copied layouts hold (a line of the
    resource broker's ledger)."""
    with _cache_lock:
        return sum(entry[1] for cache in _LAYOUT_CACHES.values()
                   for entry in cache.values())


def trim_layout_caches(target_bytes: int) -> int:
    """Tier ladder's HBM rung for the exchange caches: drop least-recently
    used layouts until the total fits `target_bytes`.  Returns bytes
    freed; a dropped layout rebuilds at the next bind (one re-exchange),
    exactly like an evicted plate."""
    freed = 0
    with _cache_lock:
        total = sum(entry[1] for cache in _LAYOUT_CACHES.values()
                    for entry in cache.values())
        for cache in list(_LAYOUT_CACHES.values()):
            while cache and total > max(0, int(target_bytes)):
                _k, entry = cache.popitem(last=False)
                total -= entry[1]
                freed += entry[1]
            if total <= max(0, int(target_bytes)):
                break
    return freed


def _cache_key(tables, static, params, ctx, kind: str):
    try:
        hash(params)
    except TypeError:
        return None
    return (kind, ctx.token, static,
            tuple(id(dt.valid) for dt in tables), params)


def _cache_get_put(compiled, key, tables, compute):
    from snappydata_tpu_torch import config

    if key is None:
        value, nbytes = compute()
        return value, nbytes, False
    cache = _layout_cache(compiled)
    with _cache_lock:
        hit = cache.get(key)
        # the key carries id(valid) per bound table — the weakrefs prove
        # they still point at those exact tensors (ids get reused after
        # GC; a stale hit would serve another version's layout)
        if hit is not None and all(
                r() is dt.valid for r, dt in zip(hit[2], tables)):
            cache.move_to_end(key)
            return hit[0], hit[1], True
    value, nbytes = compute()
    cap = int(config.global_properties().get(
        "mesh_shuffle_cache_entries", 4) or 0)
    refs = tuple(weakref.ref(dt.valid) for dt in tables)
    with _cache_lock:
        cache[key] = (value, nbytes, refs)
        while cap and len(cache) > cap:
            cache.popitem(last=False)
    return value, nbytes, False


def _apply_shuffle(compiled, meta, rels, tables, static, params, ctx, reg):
    """Bucketed exchange of BOTH join sides (cached per bind identity);
    returns the new relation list."""
    from snappydata_tpu_torch.parallel.mesh import dispatch_lock
    from snappydata_tpu_torch.storage.device import place_remote

    key = _cache_key(tables, static, params, ctx, "shuf")

    def compute():
        t0 = time.perf_counter()
        # the exchange reads the bound plates and builds the exchanged
        # layouts: it holds the dispatch fence like every other
        # multi-slot dispatch (counters stay outside: a leaf lock)
        with dispatch_lock:
            replaced: Dict[int, tuple] = {}
            nbytes = 0
            moved_rows = 0
            for side, rel in (("probe", meta["probe_rel"]),
                              ("build", meta["build_rel"])):
                ri = _rel_index(compiled, rel)
                keys, valid = _encoded_keys(compiled, meta, side, rels)
                cap = int(rels[ri][1].shape[1])
                perm, live, b_new, moved = _bucket_layout(
                    keys, valid, cap, ctx.num_devices, valid.numel() // cap)
                replaced[ri], nb = _exchange_relation(
                    rels[ri], perm, live, b_new, cap)
                if ctx.spans_cards:
                    # the layout is cached: its blocks cross cards once
                    place_remote(replaced[ri], ctx, b_new)
                nbytes += nb
                moved_rows += moved
            if ctx.home.type == "cuda":
                # locklint: blocking-under-lock the exchange completes
                # inside the fence it was dispatched under
                torch.cuda.synchronize(ctx.home)
        reg.inc("mesh_exchange_bytes", nbytes)
        reg.inc("mesh_exchange_rows", moved_rows)
        reg.record_time("mesh_exchange", time.perf_counter() - t0)
        return replaced, nbytes

    replaced, _nb, hit = _cache_get_put(compiled, key, tables, compute)
    if hit:
        reg.inc("mesh_exchange_cache_hits")
    out = list(rels)
    for i, v in replaced.items():
        out[i] = v
    return out


def _apply_broadcast(compiled, rels, sharded, tables, static, params, ctx,
                     reg) -> Dict:
    """Replicate every non-probe relation to each slot: on the home
    device a slot reads the bound tensors themselves; for every other
    card one copy, cached per bind identity.  Returns {(relation index,
    device name): relation on that card}."""
    build = [i for i in range(len(rels)) if i not in sharded]
    if not build:
        return {}
    key = _cache_key(tables, static, params, ctx, "bcast")

    def compute():
        copies: Dict = {}
        held = 0
        for dev in {s.device for s in ctx.mesh.slots} - {ctx.home}:
            for ri in build:
                copies[(ri, str(dev))] = _to(rels[ri], dev)
                held += _nbytes(copies[(ri, str(dev))])
        # broadcast volume stays under its OWN metric, as the reference's
        # (the build's bytes times the slots that read it); the layout
        # cache holds only the copies made for other cards
        reg.inc("mesh_broadcast_bytes",
                sum(_nbytes(rels[ri]) for ri in build) * ctx.num_devices)
        return copies, held

    copies, _nb, hit = _cache_get_put(compiled, key, tables, compute)
    if hit:
        reg.inc("mesh_broadcast_cache_hits")
    return copies
