"""Plan compiler + executor.

Port of snappydata_tpu/engine/executor.py, cut to the analytic scan and
the device join: one resolved logical plan (Scan / Filter / Project /
Join, with an optional Aggregate root) lowers to ONE Python callable over
stacked column-batch tensors — the whole-stage-codegen analogue (ref:
ColumnTableScan.doProduce core/.../columnar/ColumnTableScan.scala:186,
SnappyHashAggregateExec):

  Relation  -> stacked [B, C] device plates (storage/device.py)
  Filter    -> valid &= predicate
  Project   -> expression re-map
  Join      -> sorted build artifact + searchsorted match ranges: unique
               builds gather on the probe shape, others expand one-to-many
               into a bucketed flat axis, left/right/full NULL-extend
               (ops/join.py)
  Aggregate -> dictionary / vdict fast-path group index, or the generic
               hash-key lane (combined int64 keys, sorted unique,
               searchsorted), then the slot loop: the fused grouped
               kernel (ops/group_reduce.py), the Kahan kernel
               (ops/kahan_reduce.py), the dictionary-space SUM and the
               run-space SUM/COUNT (ops/code_agg.py) and the packed
               reduction families (ops/reduction.py)

  WindowProject -> one stable-sort chain per (PARTITION BY, ORDER BY),
               segmented doubling scans and searchsorted segment / tie
               bounds, scattered back to table order

Everything above the aggregate (ORDER BY / LIMIT / DISTINCT / outer
projects) runs on the host over the small reduced result.  Window
shapes the device lane lacks and the functions the port's expression
lowering lacks raise CompileError, and the executor answers those plans with the host
evaluator (engine/hosteval.py), as the reference does for constructs it
cannot lower.  Data-dependent limits (a join expansion past its bucket,
generic keys past max_groups, an exact-decimal sum at int64 risk) raise
the plan's overflow flag, read once per execution, which reroutes the
same way.

Partial-raw compiles (`Compiler(partial_raw=True)`, the tiled scan's
partial program) force data-independent group cards and tag each output
with its merge op, so `CompiledPlan.execute_raw` outputs of successive
tiles fold elementwise on the device (`merge_tile_outs`).

PyTorch runs eagerly, so "compiling" a plan builds the closures once; the
closures read their static inputs (knob tokens, padded dictionary sizes)
at every execution, so flipping a knob needs no plan-cache flush.
Compiled plans are cached on the tokenized plan (ref: SnappySession plan
cache :2560-2566, PlanCacheSize 3000).
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.engine import hosteval
from snappydata_tpu_torch.engine.exprs import (ARRAY_DEVICE_FUNCS,
                                               STRING_VALUE_FUNCS,
                                               CompileError, DVal,
                                               ExprBuilder, MapDicts,
                                               Runtime, StructDicts,
                                               _is_exact_decimal, _or_null)
from snappydata_tpu_torch.engine.result import Result
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.ops import code_agg, reduction
from snappydata_tpu_torch.ops import group_reduce as _gr
from snappydata_tpu_torch.ops import join as _dj
from snappydata_tpu_torch.ops.group_reduce import grouped_reduce
from snappydata_tpu_torch.ops.kahan_reduce import masked_kahan_sum
from snappydata_tpu_torch.resource.context import check_current
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.analyzer import _expr_name, expr_type
from snappydata_tpu_torch.storage import mvcc
from snappydata_tpu_torch.storage.device import (DeviceTable,
                                                 batch_bucket,
                                                 build_device_table,
                                                 complex_device_eligible,
                                                 current_scan_scale,
                                                 map_device_eligible,
                                                 numeric_key_domain,
                                                 scan_window_active,
                                                 struct_device_eligible)
from snappydata_tpu_torch.storage.device_decode import (BitPlate, CodePlate,
                                                        RlePlate, bit_values,
                                                        compressed_fallback,
                                                        rle_values)
from snappydata_tpu_torch.storage.table_store import RowTableData
from snappydata_tpu_torch.utils import locks


# aggregates whose argument may be a string (dictionary codes count and
# compare exactly; sums and extremes over codes would not)
_COUNT_AGGS = ("count", "count_distinct", "approx_count_distinct")


@dataclasses.dataclass
class OutCol:
    name: str
    dtype: T.DataType
    dict_provider: Optional[Callable[[], np.ndarray]] = None


@dataclasses.dataclass
class RelOut:
    """Output of a relational node: ordinal -> DVal + validity mask.

    `runf` is the run-space state of the filters applied so far, the
    alignment proof of the RLE aggregate lane: "pure" (no filter yet),
    (rends, run_mask) when every filter reduced in run space over the one
    run partition `rends`, None once a filter left run space."""

    cols: Dict[int, DVal]
    valid: torch.Tensor
    runf: object = None


class _RelationInput:
    """One base-table leaf: binds the current snapshot's plates at
    execution time.

    `sargs` holds sargable conjuncts (col ordinal, op, literal-getter) the
    binder evaluates against per-batch min/max stats to skip whole batches
    (ref: stats-row batch skipping + columnBatchesSkipped metric,
    ColumnTableScan.scala:115-130); `str_sargs` holds string equalities
    whose literal, absent from the table dictionary, matches no batch.

    Join relations set two flags: `allow_code = False` binds decoded
    plates (cached build artifacts and probe-key encodes read flat
    [B*cap] value layouts), and `no_skip = True` on an artifact-backed
    build turns off batch skipping (the artifact's sort order indexes
    the FULL flat layout; a skipped batch would point it at the wrong
    rows — the in-plan pass mask applies the filter instead)."""

    def __init__(self, info, used: List[int]):
        self.info = info
        self.used = used
        self.sargs: List[Tuple[int, str, Callable]] = []
        self.str_sargs: List[Tuple[int, Callable]] = []
        self.no_skip = False
        self.allow_code = True
        self._tls = threading.local()

    def bind(self, device: torch.device):
        if isinstance(self.info.data, RowTableData):
            dt = _row_table_device(self.info, self.used, device)
        else:
            dt = build_device_table(self.info.data, self.used, device,
                                    code_ok=self.allow_code)
        self._tls.dt = dt
        return dt

    def bound(self):
        """The full DeviceTable of this thread's current bind — what the
        join's artifact and expansion bound read, before batch skipping."""
        return self._tls.dt

    def unbind(self) -> None:
        self._tls.dt = None

    def keep_mask(self, dt, params) -> Optional[np.ndarray]:
        """bool [B] of batches that can contain matches; None = keep all."""
        if (not self.sargs and not self.str_sargs) or self.no_skip:
            return None
        keep = None
        for ci, op, get_lit in self.sargs:
            smin = dt.stats_min.get(ci)
            smax = dt.stats_max.get(ci)
            if smin is None:
                continue
            try:
                v = float(get_lit(params))
            except (TypeError, ValueError):
                continue
            # unknown stats (NaN) always keep
            if op in (">", ">="):
                k = ~(smax < v) if op == ">=" else ~(smax <= v)
            elif op in ("<", "<="):
                k = ~(smin > v) if op == "<=" else ~(smin >= v)
            elif op == "=":
                k = ~((smin > v) | (smax < v))
            else:
                continue
            k = k | np.isnan(smin)
            keep = k if keep is None else (keep & k)
        return self._dict_keep(dt, params, keep)

    def _dict_keep(self, dt, params, keep) -> Optional[np.ndarray]:
        """Dictionary-domain batch skipping: an equality literal missing
        from a batch's sorted VALUE_DICT dictionary — or from a string
        column's table dictionary — can't match a row of that batch.
        Counted as batches_skipped_dict."""
        extra = None
        for ci, op, get_lit in self.sargs:
            if op != "=":
                continue
            dom = dt.dict_domains.get(ci)
            if dom is None:
                continue
            try:
                v = float(get_lit(params))
            except (TypeError, ValueError):
                continue
            host, sizes = dom
            present = np.ones(host.shape[0], dtype=np.bool_)
            for i in range(host.shape[0]):
                sz = int(sizes[i])
                if sz == 0:
                    continue   # no dictionary for this batch: keep
                p = int(np.searchsorted(host[i, :sz], v))
                present[i] = p < sz and host[i, p] == v
            extra = present if extra is None else (extra & present)
        for ci, get_lit in self.str_sargs:
            d = dt.dictionaries.get(ci)
            if d is None or not len(d):
                continue
            v = get_lit(params)
            if v is not None and not bool(np.any(d == v)):
                # absent from the table-wide dictionary: no batch of
                # this relation can match the conjunct
                extra = np.zeros(dt.num_batches, dtype=np.bool_)
        if extra is None:
            return keep
        base = keep if keep is not None \
            else np.ones(dt.num_batches, dtype=np.bool_)
        newly = int((base & ~extra).sum())
        if newly:
            global_registry().inc("batches_skipped_dict", newly)
        return base & extra


class CompiledPlan:
    """A device region lowered to a callable + bind metadata."""

    def __init__(self, relations: List[_RelationInput],
                 aux_builders: List[Callable],
                 static_providers: List[Callable[[], int]],
                 emitter: Callable,
                 out_scope: List["_ScopeCol"],
                 is_aggregate: bool,
                 agg_notes: Optional[Dict] = None,
                 bind_checks: Optional[List[Callable]] = None,
                 tile_merge: Optional[Dict] = None,
                 pre_emit: Optional[Callable] = None):
        self.relations = relations
        self.aux_builders = aux_builders
        self.static_providers = static_providers
        self.emitter = emitter
        self.out_scope = out_scope  # dict_provider read at assemble time
        self.is_aggregate = is_aggregate
        # per static key: the reduction strategies + lanes the aggregate
        # took, surfaced as per-execution metrics
        self.agg_notes = agg_notes
        # data-dependent validity run at EVERY bind (the device_join knob,
        # 2^53 key checks): raising CompileError reroutes to the host path
        self.bind_checks = bind_checks or []
        # partial-raw merge metadata: per-output merge ops + the group-card
        # check of the tiled scan's on-device partial merge
        self.tile_merge = tile_merge
        # phase A of a cacheable aggregate (its emitter `run_agg` is
        # phase B when handed the entry), None elsewhere
        self.pre_emit = pre_emit
        # (static, batch bucket) keys of the fused dispatches run so far
        self._batched_keys: set = set()

    def _bind(self, params: Tuple, device: torch.device):
        # one bind and its launches are the atomic unit of work: the
        # cooperative cancellation point sits right before them
        check_current()
        reg = global_registry()
        for check in self.bind_checks:
            check()
        tables = [r.bind(device) for r in self.relations]
        rels = []
        for r, dt in zip(self.relations, tables):
            keep = r.keep_mask(dt, params)
            take_idx = None
            if keep is not None and not keep.all():
                # batch skipping: gather only qualifying batches, padded
                # to a {2^k, 1.5*2^k} bucket like the bind
                kept = np.flatnonzero(keep)
                reg.inc("column_batches_skipped",
                        int(dt.num_batches - len(kept)))
                b_new = batch_bucket(len(kept))
                pad_valid = np.zeros(b_new, dtype=np.bool_)
                pad_valid[:len(kept)] = True
                idx = np.zeros(b_new, dtype=np.int64)
                idx[:len(kept)] = kept
                take_idx = torch.from_numpy(idx).to(device)
                pad_mask = torch.from_numpy(pad_valid).to(device)[:, None]
            reg.inc("column_batches_seen", int(dt.num_batches))

            def take(t):
                return t if take_idx is None or t is None \
                    else torch.index_select(t, 0, take_idx)

            cols = {}
            for ci in r.used:
                col = dt.columns[ci]
                if isinstance(col, (CodePlate, RlePlate, BitPlate)):
                    # encoded plates are [B, ...]-leading field-wise
                    col = type(col)(*(take(f) for f in col))
                else:
                    col = take(col)
                cols[ci] = (col, take(dt.nulls.get(ci)))
            valid = dt.valid if take_idx is None \
                else take(dt.valid) & pad_mask
            rels.append((cols, valid))
        # aux builders return host arrays (LUTs) or, for join build
        # artifacts, tensors already on the device; statics run AFTER
        # them, so a join's mode provider reuses the artifact its aux
        # builder just fetched
        aux = [_upload(b(params), device) for b in self.aux_builders]
        static = tuple(p() for p in self.static_providers)
        return rels, aux, static, _DeviceParams(params, device)

    def run(self, params: Tuple, device: torch.device):
        """Bind + run; returns ((mask, [(value, null), ...]), overflow)
        still on the device — `overflow` is None or a bool tensor."""
        try:
            rels, aux, static, pvals = self._bind(params, device)
            ctx = _RunCtx(self.relations, rels, aux, pvals, static, device)
            outs = self._run_phases(ctx, params)
        finally:
            # the bind's DeviceTables serve this run only: a cached plan
            # must not keep a table's plates alive past a demotion or an
            # eviction of its cache entry
            for r in self.relations:
                r.unbind()
        self._count_agg_notes(static)
        return outs, ctx.overflow

    def _run_phases(self, ctx, params: Tuple):
        """The emitter over one bind.  A cacheable aggregate splits in two
        phases while `gidx_cache_bytes` > 0 and no tile window is bound
        (a window rotates the bind identity every tile, so the cache could
        never hit): phase A (validity + group index) comes from the
        group-index cache when this plan, static key and params ran over
        the same bound tables before, and only phase B runs."""
        use_pre = self.pre_emit is not None \
            and (config.global_properties().gidx_cache_bytes or 0) > 0 \
            and not scan_window_active()
        if not use_pre:
            return self.emitter(ctx)
        try:
            hash(params)
        except TypeError:      # an unhashable literal: no caching
            return self.emitter(ctx)
        reg = global_registry()
        tables = [r.bound() for r in self.relations]
        pre = _pre_cache_get(self, ctx.static, params, tables)
        if pre is None:
            reg.inc("gidx_cache_misses")
            pre = self.pre_emit(ctx)
            _pre_cache_put(self, ctx.static, params, tables, pre)
        else:
            reg.inc("gidx_cache_hits")
        return self.emitter(ctx, pre)

    def _count_agg_notes(self, static) -> None:
        """Per-execution metrics from the aggregate's notes: reduction
        passes + strategies, the compressed-domain lanes it engaged
        (agg_code_domain / agg_dict_space / agg_rle_runs), and counted
        run-misalignment fallbacks — an RLE plate that was eligible but
        whose filter left run space never degrades silently."""
        note = self.agg_notes.get(static) if self.agg_notes else None
        if note is None:
            return
        reg = global_registry()
        reg.inc("agg_reduce_passes", note["passes"])
        for s in note["strategies"]:
            reg.inc("agg_strategy_" + s)
        for lane in note["lanes"]:
            reg.inc("agg_" + lane)
        if note["rle_fallbacks"]:
            tref = note.get("table")
            compressed_fallback("rle_agg", note["rle_fallbacks"],
                                table=tref() if tref is not None else None)

    def execute(self, params: Tuple, device: torch.device) -> Result:
        (mask, pairs), overflow = self.run(params, device)
        # the overflow flag is read once per execution
        if overflow is not None and bool(overflow):
            raise CompileError(
                "device overflow (group-by cardinality beyond max_groups, "
                "an exact-decimal sum at int64 risk, or a join expansion "
                "past its bound): host path")
        return self.assemble_device(mask, pairs)

    def execute_raw(self, params: Tuple, device: torch.device):
        """Run the compiled region and return (mask, pairs, overflow)
        still on the device, with no host copy: CUDA's asynchronous
        launch lets the tiled scan bind the next tile while this one
        reduces, and the tile partials merge on the device."""
        (mask, pairs), overflow = self.run(params, device)
        return mask, pairs, overflow

    def execute_batched(self, params_list, device: torch.device,
                        bucket: Optional[int] = None):
        """Fused dispatch over a stack of bind vectors (the serving
        micro-batcher; ref snappydata_tpu/engine/executor.py
        `execute_batched`).  The relations bind ONCE; the emitter then
        runs once per request on that one bind, with the request's own
        aux builds and literals, so every kernel launches once per
        request.  Each output stacks along a new leading batch axis on the
        device (outputs whose group count depends on the data pad to the
        longest, mask False on the padding), and the whole batch comes
        home in ONE device-to-host copy.  `bucket` is the batcher's padded
        batch size (the reference pads the binds to it; only the live
        requests run here), the size half of the `serving_vmap_compiles`
        key.  Returns (tables, outs), outs =
        (mask [B, G], [(value [B, ...], null [B, ...] | None)], overflow
        [B]) as host arrays; `assemble_batched` slices request i.

        Batch skipping is off, as in the reference (different binds could
        keep different batch subsets), and so is the group-index cache
        (its key is per-params).  Raises ValueError when the requests'
        aux builds differ in shape (value-dependent LUTs, which the
        reference cannot stack either) and CompileError on a bind-check
        failure: the caller re-executes each request on its own."""
        reg = global_registry()
        # the plate width and the literals' dtypes follow the device
        # scope: a fused dispatch runs in its device's scope whatever
        # thread leads it
        with config.device_scope(device):
            for check in self.bind_checks:
                check()
            try:
                tables = [r.bind(device) for r in self.relations]
                rels = [({ci: (dt.columns[ci], dt.nulls.get(ci))
                          for ci in r.used}, dt.valid)
                        for r, dt in zip(self.relations, tables)]
                per_req_aux = [[b(p) for b in self.aux_builders]
                               for p in params_list]
                shapes = {tuple(_aux_shape(a) for a in aux)
                          for aux in per_req_aux}
                if len(shapes) > 1:
                    raise ValueError("aux builds of the batch do not stack "
                                     "(value-dependent shapes)")
                static = tuple(p() for p in self.static_providers)
                key = (static, bucket or len(params_list))
                if key not in self._batched_keys:
                    # the reference compiles one vmapped program per
                    # (static key, bucket); counted alike, though nothing
                    # compiles here
                    reg.inc("serving_vmap_compiles")
                    self._batched_keys.add(key)
                outs = []
                for p, aux in zip(params_list, per_req_aux):
                    ctx = _RunCtx(self.relations, rels,
                                  [_upload(a, device) for a in aux],
                                  _DeviceParams(p, device), static, device)
                    mask, pairs = self.emitter(ctx)
                    outs.append((mask, pairs, ctx.overflow))
            finally:
                for r in self.relations:
                    r.unbind()
            self._count_agg_notes(static)
            host = _stack_home(outs, device)
        reg.inc("serving_bulk_transfers")
        return tables, host

    def tile_merge_ok(self) -> bool:
        """Bind-time check that a partial-raw compile's group-index space
        is data-independent and small enough for aligned [G] merging."""
        if not self.tile_merge:
            return False
        try:
            return self.tile_merge["cards"]() <= self.tile_merge["max_groups"]
        except CompileError:
            return False

    def assemble_device(self, mask, pairs) -> Result:
        """Device outputs -> host Result: one host transfer per output
        array, after the whole region ran."""
        host = [(v.cpu().numpy(), nl.cpu().numpy() if nl is not None
                 else None) for v, nl in pairs]
        return self._assemble(mask.cpu().numpy(), host)

    def _assemble(self, mask: np.ndarray, pairs) -> Result:
        mask = mask.reshape(-1)
        keep = mask.nonzero()[0]
        names, cols, nulls, dtypes = [], [], [], []
        for oc, (v, nl) in zip(self.out_scope, pairs):
            data = v.reshape(-1)[keep] if data_needs_mask(v, mask) \
                else v.reshape(-1)
            nmask = None
            if nl is not None:
                nmask = nl.reshape(-1)[keep] if data_needs_mask(nl, mask) \
                    else nl.reshape(-1)
            if oc.dict_provider is not None:
                d = oc.dict_provider()
                if len(d) == 0:
                    data = np.full(data.shape, None, dtype=object)
                else:
                    data = np.asarray(d, dtype=object)[
                        np.clip(data, 0, len(d) - 1)]
            names.append(oc.name)
            cols.append(data)
            nulls.append(nmask)
            dtypes.append(oc.dtype)
        return Result(names, cols, nulls, dtypes)


def data_needs_mask(v, mask) -> bool:
    return int(np.prod(np.shape(v))) == mask.shape[0]


# --- group-index (phase A) cache ------------------------------------------
# Cacheable aggregates split into phase A (filtered validity, group index,
# the one-hot on the matmul strategy) and phase B.  Entries key on (plan
# identity, static key, params) and hold weak references to the bound
# tables' `valid` tensors, which the device cache (storage/device.py)
# hands back unchanged while a table's snapshot is current: a mutation,
# a demotion or an eviction rotates them, which invalidates the entry
# with no version plumbing.  An entry holds only its own tensors, never a
# table's plates.  LRU, byte-capped by `gidx_cache_bytes` (ref
# snappydata_tpu/engine/executor.py, the group-index cache).

_PRE_CACHE: Dict[tuple, dict] = {}
_PRE_CACHE_BYTES = [0]
_PRE_CACHE_LOCK = locks.named_lock("executor.pre_cache")
_pre_tick = [0]


def gidx_cache_nbytes() -> int:
    """Device bytes held by the group-index cache: a line of the resource
    broker's ledger."""
    return int(_PRE_CACHE_BYTES[0])


def _bind_identity(tables):
    """Per-bind identity tokens: the `valid` tensors of the device
    cache's entry, reused across binds while the snapshot is current (the
    DeviceTable wrapper is rebuilt per bind, so it cannot serve)."""
    return [t.valid for t in tables]


def _pre_cache_tick() -> int:
    _pre_tick[0] += 1
    return _pre_tick[0]


def _pre_cache_get(plan, static, pkey, tables):
    key = (id(plan), static, pkey)
    ident = _bind_identity(tables)
    with _PRE_CACHE_LOCK:
        entry = _PRE_CACHE.get(key)
        if entry is None:
            return None
        if entry["plan"]() is not plan \
                or len(entry["binds"]) != len(ident) \
                or any(r() is not t for r, t in zip(entry["binds"], ident)):
            _PRE_CACHE.pop(key, None)
            _PRE_CACHE_BYTES[0] -= entry["nbytes"]
            return None
        entry["tick"] = _pre_cache_tick()
        return entry["pre"]


def _pre_cache_put(plan, static, pkey, tables, pre) -> None:
    budget = int(config.global_properties().gidx_cache_bytes or 0)
    nbytes = pre.nbytes()
    if nbytes > budget:
        return  # one oversized entry would evict everything for nothing
    binds = tuple(weakref.ref(t) for t in _bind_identity(tables))
    with _PRE_CACHE_LOCK:
        # entries of collected plans or rotated binds are dead weight
        # until LRU pressure: purge them now
        for k in [k for k, e in _PRE_CACHE.items()
                  if e["plan"]() is None
                  or any(r() is None for r in e["binds"])]:
            _PRE_CACHE_BYTES[0] -= _PRE_CACHE.pop(k)["nbytes"]
        while _PRE_CACHE and _PRE_CACHE_BYTES[0] + nbytes > budget:
            victim = min(_PRE_CACHE, key=lambda k: _PRE_CACHE[k]["tick"])
            _PRE_CACHE_BYTES[0] -= _PRE_CACHE.pop(victim)["nbytes"]
        old = _PRE_CACHE.pop((id(plan), static, pkey), None)
        if old is not None:  # concurrent misses on one key: replace once
            _PRE_CACHE_BYTES[0] -= old["nbytes"]
        _PRE_CACHE[(id(plan), static, pkey)] = {
            "plan": weakref.ref(plan), "binds": binds, "pre": pre,
            "nbytes": nbytes, "tick": _pre_cache_tick()}
        _PRE_CACHE_BYTES[0] += nbytes


def _pre_cache_attach(pre, onehot) -> None:
    """Add phase B's one-hot to a cached entry, within the budget (LRU
    eviction of other entries first; an entry that would not fit keeps
    going without it)."""
    extra = int(onehot.numel()) * onehot.element_size()
    budget = int(config.global_properties().gidx_cache_bytes or 0)
    with _PRE_CACHE_LOCK:
        key = next((k for k, e in _PRE_CACHE.items() if e["pre"] is pre),
                   None)
        if key is None or _PRE_CACHE[key]["nbytes"] + extra > budget:
            return
        while _PRE_CACHE_BYTES[0] + extra > budget:
            victim = min((k for k in _PRE_CACHE if k != key),
                         key=lambda k: _PRE_CACHE[k]["tick"])
            _PRE_CACHE_BYTES[0] -= _PRE_CACHE.pop(victim)["nbytes"]
        pre.onehot = onehot
        _PRE_CACHE[key]["nbytes"] += extra
        _PRE_CACHE_BYTES[0] += extra


def clear_gidx_cache() -> None:
    with _PRE_CACHE_LOCK:
        _PRE_CACHE.clear()
        _PRE_CACHE_BYTES[0] = 0


def _aux_shape(x):
    """Shape signature of one aux build: stacked requests must agree."""
    if isinstance(x, tuple):
        return tuple(_aux_shape(e) for e in x)
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _stack_home(outs, device: torch.device):
    """Stack B requests' (mask, pairs, overflow) along a new leading axis
    on the device and copy the whole batch to the host in ONE transfer:
    every stacked tensor is laid out byte-wise, 8-byte aligned, in one
    uint8 buffer that crosses once, then is split and re-typed on the
    host.  A request's row-shaped outputs (one value per mask row) pad
    to the batch's longest mask with the mask False."""
    g = max(int(m.numel()) for m, _p, _o in outs)

    def rows_of(t, rows: int, fill):
        """A row-shaped output (one value per mask row) flat and padded
        to g rows; anything else flat as it is."""
        t = torch.as_tensor(t, device=device).reshape(-1)
        if t.shape[0] == rows and rows < g:
            t = torch.cat([t, torch.full((g - rows,), fill, dtype=t.dtype,
                                         device=t.device)])
        return t

    masks, cols = [], None
    for mask, pairs, _ov in outs:
        rows = int(mask.numel())
        masks.append(rows_of(mask, rows, False))
        if cols is None:
            cols = [[] for _ in pairs]
        for j, (v, nl) in enumerate(pairs):
            cols[j].append((rows_of(v, rows, 0),
                            rows_of(nl, rows, False)
                            if nl is not None else None))
    stacked = [torch.stack(masks)]
    has_null = []
    for col in cols or []:
        stacked.append(torch.stack([v for v, _ in col]))
        if any(nl is not None for _, nl in col):
            stacked.append(torch.stack([
                nl if nl is not None else torch.zeros_like(
                    v, dtype=torch.bool) for v, nl in col]))
            has_null.append(True)
        else:
            has_null.append(False)
    ovs = [o.reshape(()).to(torch.bool) if isinstance(o, torch.Tensor)
           else torch.tensor(bool(o), device=device) for _m, _p, o in outs]
    stacked.append(torch.stack(ovs))
    # one byte buffer, each piece at an 8-byte aligned offset
    parts, layout, off = [], [], 0
    for t in stacked:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        n = int(raw.shape[0])
        padn = (-n) % 8
        parts.append(raw)
        if padn:
            parts.append(torch.zeros(padn, dtype=torch.uint8,
                                     device=t.device))
        layout.append((off, n, t.dtype, tuple(t.shape)))
        off += n + padn
    buf = torch.cat(parts).cpu().numpy()
    arrays = [buf[o:o + n].view(_NP_DTYPES[dt]).reshape(shape)
              for o, n, dt, shape in layout]
    mask = arrays[0]
    pairs, i = [], 1
    for hn in has_null:
        v = arrays[i]
        i += 1
        nl = None
        if hn:
            nl = arrays[i]
            i += 1
        pairs.append((v, nl))
    return mask, pairs, arrays[i]


_NP_DTYPES = {torch.bool: np.bool_, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64}


def _compressed_token() -> int:
    """scan_compressed_domain as a small int on the static key."""
    s = str(config.global_properties().get(
        "scan_compressed_domain", "auto") or "auto").lower()
    return ("off", "auto", "on").index(s) if s in ("off", "auto", "on") \
        else 1


def _strategy_token(props) -> int:
    """agg_reduce_strategy as a small int on the static key."""
    s = str(props.get("agg_reduce_strategy", "auto") or "auto").lower()
    return reduction.STRATEGIES.index(s) if s in reduction.STRATEGIES \
        else 0


_CODE_AGG_TOKENS = {"off": 0, "auto": 1, "on": 2}


def _code_agg_token(props) -> int:
    """agg_on_codes as a small int on the static key."""
    s = str(props.get("agg_on_codes", "auto") or "auto").lower()
    return _CODE_AGG_TOKENS.get(s, 1)


def _kernel_token() -> int:
    """The two kernel knobs (pallas_reduce, pallas_group_reduce) as bits
    of the static key, so a flip re-keys the aggregate notes."""
    props = config.global_properties()
    return int(bool(props.pallas_reduce)) \
        | (int(bool(props.pallas_group_reduce)) << 1)


def _rle_run_mask(runf, rpl):
    """Per-run survivor mask of `rpl` under the relation's run-space
    filter state, or None when the alignment proof does not cover this
    plate (a filter over another run partition, or one that left run
    space)."""
    if runf == "pure":
        return torch.ones(rpl.ends.shape, dtype=torch.bool,
                          device=rpl.ends.device)
    if isinstance(runf, tuple) and runf[0] is rpl.ends:
        return runf[1]
    return None


def _vdict_card(dom, max_groups: int) -> int:
    """Static card of a vdict key: padded domain size — or max_groups+1
    when the domain declined (too many distincts / NaN), which pushes the
    shape off the fast path."""
    return _padded_size(len(dom)) if dom is not None else max_groups + 1


def _vdict_lut(dom) -> np.ndarray:
    """Aux LUT of a vdict key: the sorted domain padded to its static
    card by repeating the last value (stays sorted; searchsorted
    side='left' maps the pad value to its first occurrence)."""
    if dom is None or len(dom) == 0:
        return np.zeros(1, dtype=np.float64)
    pad = _padded_size(len(dom))
    out = np.empty(pad, dtype=dom.dtype)
    out[:len(dom)] = dom
    out[len(dom):] = dom[-1]
    return out


def _upload(x, device: torch.device):
    """One aux input on `device`: tensors (and tuples of them) pass
    through, host arrays upload."""
    if isinstance(x, (torch.Tensor, tuple)):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _param_dtype(v) -> torch.dtype:
    """The dtype a tokenized literal uploads as (the micro-batcher's bind
    signature reads it without an upload)."""
    if isinstance(v, (bool, np.bool_)):
        return torch.bool
    if isinstance(v, (int, np.integer)):
        return torch.int64
    if isinstance(v, (float, np.floating)):
        return torch.float64 if config.use_float64() else torch.float32
    # strings ride only through LUT aux builders; position still needs a slot
    return torch.int32


def _param_scalar(v, device: torch.device) -> torch.Tensor:
    """One tokenized literal as a 0-dim tensor on `device`."""
    dt = _param_dtype(v)
    if dt is torch.int32:
        return torch.zeros((), dtype=dt, device=device)
    value = bool(v) if dt is torch.bool else \
        int(v) if dt is torch.int64 else float(v)
    return torch.tensor(value, dtype=dt, device=device)


class _DeviceParams:
    """The tokenized literals of one execution as 0-dim tensors on the
    device, each uploaded on its first read.  A long IN list (an IN
    subquery's result) reaches the device only through its sorted aux
    tensor, so its thousands of params are never uploaded one by one."""

    __slots__ = ("_vals", "_device", "_cache")

    def __init__(self, vals: Tuple, device: torch.device):
        self._vals = vals
        self._device = device
        self._cache: Dict[int, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self._vals)

    def __getitem__(self, i: int) -> torch.Tensor:
        t = self._cache.get(i)
        if t is None:
            t = self._cache[i] = _param_scalar(self._vals[i], self._device)
        return t


# ==========================================================================
# Compiler
# ==========================================================================

class Compiler:
    """Compiles one device region (Relation/Filter/Project/Join
    [/Aggregate root]) into a CompiledPlan."""

    def __init__(self, catalog, props, partial_raw: bool = False):
        self.catalog = catalog
        self.props = props
        # partial-raw mode (tiled scans): compile a partial-aggregate plan
        # whose outputs stay mergeable [G] tensors — group cards are
        # forced data-independent (nullable keys always get their NULL
        # code slot) so every tile shares one aligned group-index space
        self.partial_raw = partial_raw
        self._tile_merge: Optional[Dict] = None
        self.relations: List[_RelationInput] = []
        self.aux_builders: List[Callable] = []
        self.static_providers: List[Callable] = []
        self.bind_checks: List[Callable] = []
        self._agg_notes: Optional[Dict] = None

    def _add_static(self, provider: Callable[[], int]) -> int:
        self.static_providers.append(provider)
        return len(self.static_providers) - 1

    def _new_builder(self, col_types, nullable, dict_getters) -> ExprBuilder:
        """An ExprBuilder whose aux LUTs land in this plan's aux list: the
        emitted closures index the full list, so builders never need
        offsets of their own."""
        b = ExprBuilder(col_types, nullable, dict_getters)

        def register(builder_fn) -> int:
            self.aux_builders.append(builder_fn)
            return len(self.aux_builders) - 1

        b._register_aux = register
        return b

    def _builder_for(self, scope) -> ExprBuilder:
        return self._new_builder(
            {i: s.dtype for i, s in enumerate(scope)},
            {i: s.nullable for i, s in enumerate(scope)},
            {i: s.dict_provider for i, s in enumerate(scope)
             if s.dict_provider is not None})

    def compile(self, plan: ast.Plan) -> CompiledPlan:
        is_agg = isinstance(plan, ast.Aggregate)
        _validate_array_usage(plan)
        self._add_static(_compressed_token)
        # column pruning: per-relation needed ordinals, DFS leaf order
        self._pruned: List[set] = []
        _collect_used(plan, None, self._pruned)
        self._prune_cursor = 0
        emitter, out_cols = self._emit_node(plan)
        out_scope = [oc if isinstance(oc, _ScopeCol)
                     else _ScopeCol(oc.name, oc.dtype, oc.dict_provider)
                     for oc in out_cols]
        pre_emit = getattr(self, "_agg_pre_emit", None)
        if self.partial_raw or not self._pre_cacheable(plan):
            pre_emit = None
        return CompiledPlan(self.relations, self.aux_builders,
                            self.static_providers, emitter, out_scope,
                            is_agg, self._agg_notes, self.bind_checks,
                            self._tile_merge, pre_emit=pre_emit)

    def _pre_cacheable(self, plan: ast.Plan) -> bool:
        """Is the aggregate's prefix (validity + group index) safe and
        worth caching?  A GROUP BY (a global aggregate's index is
        trivial) over a single relation (no join for phase B to re-run)
        with no SQL function (a builtin lowering is deterministic; a
        function body's determinism is unknowable)."""
        if not isinstance(plan, ast.Aggregate) or not plan.group_exprs:
            return False
        if len(self.relations) != 1:
            return False
        udfs = getattr(self.catalog, "_functions", None) or {}
        if udfs:
            names = {n.lower() for n in udfs}

            def any_udf(p) -> bool:
                for e in ast.plan_exprs(p):
                    for sub in ast.walk(e):
                        if isinstance(sub, ast.Func) \
                                and sub.name.lower() in names:
                            return True
                return any(any_udf(k) for k in p.children())

            if any_udf(plan):
                return False
        return True

    # -- node emitters -----------------------------------------------------

    def _emit_node(self, plan: ast.Plan):
        """(emitter(ctx) -> (mask, [(val, null)...]), out_cols) for the
        region root."""
        if isinstance(plan, ast.Aggregate):
            return self._emit_aggregate(plan)
        if isinstance(plan, ast.WindowProject):
            return self._emit_window(plan)
        rel_emit, scope = self._emit_rel(plan)

        def run_root(ctx) -> tuple:
            out = rel_emit(ctx)
            pairs = [(_broadcast_to_mask(out.cols[i].value, out.valid),
                      out.cols[i].null) for i in range(len(scope))]
            return out.valid, pairs

        return run_root, scope

    # -- window ------------------------------------------------------------

    _WINDOW_DEVICE_FUNCS = frozenset({
        "row_number", "rank", "dense_rank", "sum", "count", "avg", "min",
        "max", "lag", "lead"})

    def _emit_window(self, plan: ast.WindowProject):
        """Device OVER(): one sort per distinct (PARTITION BY, ORDER BY)
        pair — successive stable sorts, last ORDER BY key first and the
        partition key last — then segmented scans in the sorted domain
        (`_segscan`), rank / row_number from segment and tie bounds
        (`searchsorted` of the sorted segment / tie ids against
        themselves), and one scatter back to table order.  Shapes outside
        `_WINDOW_DEVICE_FUNCS`, rank without ORDER BY, ORDER BY a string
        and lag / lead with a default raise CompileError, which routes
        the plan to `hosteval.eval_window` exactly where the reference
        routes it."""
        child, scope = self._emit_rel(plan.child)
        wfs: List[ast.WindowFunc] = []

        def collect(e):
            if isinstance(e, ast.WindowFunc):
                if e not in wfs:
                    wfs.append(e)
                return
            for c in e.children():
                collect(c)

        for e in plan.exprs:
            collect(e)
        if not wfs:
            raise CompileError("window project without window functions")

        builder = self._builder_for(scope)
        groups: Dict[tuple, dict] = {}
        specs = []
        for wf in wfs:
            if wf.name not in self._WINDOW_DEVICE_FUNCS:
                raise CompileError(f"window {wf.name}: host path")
            if wf.name in ("rank", "dense_rank") and not wf.order_by:
                raise CompileError("rank without ORDER BY: host path")
            for oe, *_ in wf.order_by:
                odt = expr_type(oe)
                if odt is None or odt.name in ("string", "array", "map"):
                    raise CompileError("window ORDER BY on non-numeric "
                                       "key: host path")
            arg_run = None
            arg_dtype = None
            offset = 1
            if wf.name in ("sum", "avg", "min", "max"):
                arg_dtype = expr_type(wf.args[0])
                if arg_dtype is None or not T.is_numeric(arg_dtype):
                    raise CompileError("window aggregate over non-numeric "
                                       "argument: host path")
                arg_run = builder.emit(wf.args[0])
            elif wf.name == "count" and wf.args:
                arg_run = builder.emit(wf.args[0])
            elif wf.name in ("lag", "lead"):
                if not wf.order_by:
                    raise CompileError("lag/lead without ORDER BY")
                if len(wf.args) > 2:
                    raise CompileError("lag/lead default value: host path")
                arg_dtype = expr_type(wf.args[0])
                if arg_dtype is not None and arg_dtype.name == "string":
                    raise CompileError("lag/lead over strings: host path")
                if len(wf.args) > 1:
                    if not isinstance(wf.args[1], ast.Lit):
                        raise CompileError("non-literal lag/lead offset")
                    offset = int(wf.args[1].value)
                arg_run = builder.emit(wf.args[0])
            gk = (wf.partition_by, wf.order_by)
            if gk not in groups:
                groups[gk] = {
                    "part": [builder.emit(p) for p in wf.partition_by],
                    "order": [(builder.emit(o[0]), o[1],
                               o[2] if len(o) > 2 else None)
                              for o in wf.order_by],
                }
            specs.append((wf, gk, arg_run, arg_dtype, offset))

        # the select list sees the window values as appended columns
        ext_scope = list(scope) + [
            _ScopeCol(f"__w{i}", expr_type(wf) or T.DOUBLE, None, True)
            for i, wf in enumerate(wfs)]

        def rewrite(e):
            if isinstance(e, ast.WindowFunc):
                i = wfs.index(e)
                return ast.Col(f"__w{i}", None, len(scope) + i,
                               ext_scope[len(scope) + i].dtype)
            return e.map_children(rewrite)

        out_exprs = [rewrite(e) for e in plan.exprs]
        ext_builder = self._builder_for(ext_scope)
        out_runs = [ext_builder.emit(
            e.child if isinstance(e, ast.Alias) else e) for e in out_exprs]
        out_scope = [
            _ScopeCol(_expr_name(orig), expr_type(orig) or T.DOUBLE,
                      _derived_dict_provider(
                          e.child if isinstance(e, ast.Alias) else e,
                          ext_scope), True)
            for orig, e in zip(plan.exprs, out_exprs)]

        def run_window(ctx) -> tuple:
            fdt = torch.float64 if config.use_float64() else torch.float32
            out = child(ctx)
            valid2 = out.valid
            flatmask = valid2.reshape(-1)
            n = int(flatmask.shape[0])
            dev = flatmask.device
            idx = torch.arange(n, device=dev)
            rt = ctx.runtime(out.cols)

            def flat(dv: DVal):
                v = _broadcast_to_mask(dv.value, valid2).reshape(-1)
                nl = _broadcast_to_mask(dv.null, valid2).reshape(-1) \
                    if dv.null is not None else None
                return v, nl

            gdata: Dict[tuple, dict] = {}
            for gk, g in groups.items():
                part_flat = []
                for r in g["part"]:
                    v, nl = flat(r(rt))
                    if nl is not None:
                        # every NULL of a key is one partition, whatever
                        # filler its slot holds
                        v = torch.where(nl, torch.zeros_like(v), v)
                    part_flat.append(DVal(v, nl))
                pk = _combine_keys(part_flat) if part_flat \
                    else torch.zeros(n, dtype=torch.int64, device=dev)
                pk = torch.where(flatmask, pk, _dj.I64_MAX)
                okeys = []
                for r, asc, nf in g["order"]:
                    v, nl = flat(r(rt))
                    if v.dtype == torch.bool:
                        v = v.to(torch.int32)
                    kv = v if asc else -v
                    if nl is not None:
                        # Spark: ASC -> NULLS FIRST, DESC -> NULLS LAST,
                        # unless NULLS FIRST / LAST is explicit
                        nulls_first = nf if nf is not None else asc
                        kv = torch.where(
                            nl, reduction.extreme_value(kv.dtype,
                                                        not nulls_first),
                            kv)
                    okeys.append(kv)
                # lexsort by (pk, okeys...): stable sorts from the least
                # significant key to the most
                perm = idx
                for key in list(reversed(okeys)) + [pk]:
                    _s, p = torch.sort(key[perm], stable=True)
                    perm = perm[p]
                inv = torch.empty_like(perm)
                inv[perm] = idx
                gs = pk[perm]
                one = torch.ones(1, dtype=torch.bool, device=dev)
                new_seg = torch.cat([one, gs[1:] != gs[:-1]])
                seg_id = torch.cumsum(new_seg, 0) - 1
                seg_first = torch.searchsorted(seg_id, seg_id)
                seg_last = torch.searchsorted(seg_id, seg_id, right=True) - 1
                # the scans need as many doubling passes as the longest
                # segment of LIVE rows: filtered and padding rows share
                # one sentinel segment whose values nothing reads
                seg_len = torch.where(flatmask[perm],
                                      seg_last - seg_first + 1, 0)
                d = dict(perm=perm, inv=inv, new_seg=new_seg,
                         seg_first=seg_first, seg_last=seg_last,
                         span=int(seg_len.max()) if n else 0)
                if okeys:
                    tie_new = new_seg
                    for kv in okeys:
                        ks = kv[perm]
                        tie_new = tie_new | torch.cat([one, ks[1:] != ks[:-1]])
                    tie_id = torch.cumsum(tie_new, 0) - 1
                    d["tie_id"] = tie_id
                    d["tie_first"] = torch.searchsorted(tie_id, tie_id)
                    d["tie_last"] = torch.searchsorted(tie_id, tie_id,
                                                       right=True) - 1
                gdata[gk] = d

            win_vals: List[DVal] = []
            for wf, gk, arg_run, arg_dtype, offset in specs:
                d = gdata[gk]
                perm, inv = d["perm"], d["inv"]
                frame_end = d["tie_last"] if wf.order_by else d["seg_last"]
                if wf.name == "row_number":
                    res = idx - d["seg_first"] + 1
                    win_vals.append(DVal(res[inv], None, T.LONG))
                    continue
                if wf.name == "rank":
                    res = d["tie_first"] - d["seg_first"] + 1
                    win_vals.append(DVal(res[inv], None, T.LONG))
                    continue
                if wf.name == "dense_rank":
                    res = d["tie_id"] - d["tie_id"][d["seg_first"]] + 1
                    win_vals.append(DVal(res[inv], None, T.LONG))
                    continue
                if wf.name in ("lag", "lead"):
                    dv = arg_run(rt)
                    v, nl = flat(dv)
                    vs = v[perm]
                    k = offset if wf.name == "lag" else -offset
                    src = idx - k
                    ok = (src >= d["seg_first"]) & (src <= d["seg_last"])
                    srcc = src.clamp(0, max(n - 1, 0))
                    null_s = ~ok
                    if nl is not None:
                        null_s = null_s | nl[perm][srcc]
                    win_vals.append(DVal(vs[srcc][inv], null_s[inv],
                                         arg_dtype or dv.dtype))
                    continue
                # aggregates: sum / count / avg / min / max
                if arg_run is not None:
                    v, nl = flat(arg_run(rt))
                else:  # count(*)
                    v = torch.ones(n, dtype=torch.int64, device=dev)
                    nl = None
                vs = v[perm]
                notnull = flatmask[perm] if nl is None \
                    else ~nl[perm] & flatmask[perm]
                cnt = _segscan(torch.add, notnull.to(torch.int64),
                               d["new_seg"], d["span"])[frame_end]
                if wf.name == "count":
                    win_vals.append(DVal(cnt[inv], None, T.LONG))
                    continue
                if wf.name in ("sum", "avg"):
                    # running sums accumulate in float64 (int64 for
                    # integer sums) and cast back to the plate type: a
                    # float32 scan loses digits over long partitions
                    floating = wf.name == "avg" or vs.is_floating_point()
                    acc_dt = torch.float64 if floating else torch.int64
                    contrib = torch.where(notnull, vs,
                                          torch.zeros_like(vs)).to(acc_dt)
                    ssum = _segscan(torch.add, contrib, d["new_seg"],
                                    d["span"])[frame_end]
                    if wf.name == "avg":
                        ssum = ssum / cnt.clamp(min=1).to(torch.float64)
                    if floating:
                        ssum = ssum.to(fdt)
                    win_vals.append(DVal(ssum[inv], (cnt == 0)[inv],
                                         expr_type(wf) or T.DOUBLE))
                    continue
                # min / max
                sent = reduction.extreme_value(vs.dtype, wf.name == "min")
                contrib = torch.where(notnull, vs, sent)
                op = torch.minimum if wf.name == "min" else torch.maximum
                res = _segscan(op, contrib, d["new_seg"],
                               d["span"])[frame_end]
                win_vals.append(DVal(res[inv], (cnt == 0)[inv],
                                     arg_dtype or T.DOUBLE))

            ext_cols: Dict[int, DVal] = {}
            for i, dv in out.cols.items():
                v, nl = flat(dv)
                ext_cols[i] = DVal(v, nl, dv.dtype, dv.dictionary)
            for i, dv in enumerate(win_vals):
                ext_cols[len(scope) + i] = dv
            rt2 = ctx.runtime(ext_cols)
            # compact to the live rows on the device: the host then copies
            # and assembles only them, not the whole padded flat domain
            keep = flatmask.nonzero().squeeze(1)
            pairs = []
            for r in out_runs:
                dv = r(rt2)
                v = _broadcast_to_mask(dv.value, flatmask)[keep]
                nl = None if dv.null is None \
                    else _broadcast_to_mask(dv.null, flatmask)[keep]
                pairs.append((v, nl))
            return flatmask[keep], pairs

        return run_window, out_scope

    def _emit_rel(self, plan: ast.Plan):
        """Relational body -> (emitter(ctx) -> RelOut, scope)."""
        if isinstance(plan, ast.Relation):
            info = self.catalog.lookup_table(plan.name)
            pruned = self._pruned[self._prune_cursor] \
                if self._prune_cursor < len(self._pruned) else None
            self._prune_cursor += 1
            used = sorted(pruned) if pruned is not None \
                else list(range(len(info.schema)))
            col_store = not isinstance(info.data, RowTableData)
            for uci in used:
                fdt = info.schema.fields[uci].dtype
                if fdt.name in ("map", "struct", "array") and not (
                        col_store and complex_device_eligible(fdt)):
                    # numeric / string-element arrays, MAP<STRING, V> and
                    # flat STRUCTs of column tables have device plates
                    # (string parts ride as dictionary codes); nested
                    # complex types and row tables stay host
                    raise CompileError(
                        "complex-typed columns evaluate on the host path")
            rel_idx = len(self.relations)
            self.relations.append(_RelationInput(info, used))
            scope = [
                _ScopeCol(f.name, f.dtype, _dict_provider(info, i),
                          f.nullable)
                for i, f in enumerate(info.schema.fields)]

            def run_scan(ctx) -> RelOut:
                cols, valid = ctx.rels[rel_idx]
                return RelOut(dict(cols), valid, runf="pure")

            return run_scan, scope

        if isinstance(plan, ast.SubqueryAlias):
            return self._emit_rel(plan.child)

        if isinstance(plan, ast.Filter):
            child, scope = self._emit_rel(plan.child)
            # sargable conjuncts directly over a base scan feed per-batch
            # stats skipping at bind time
            inner = plan.child
            while isinstance(inner, ast.SubqueryAlias):
                inner = inner.child
            if isinstance(inner, ast.Relation) and self.relations:
                _collect_sargs(plan.condition, self.relations[-1])
            pred = self._builder_for(scope).emit(plan.condition)

            def run_filter(ctx) -> RelOut:
                out = child(ctx)
                if ctx.skip_filters:
                    # a group-index cache hit: the cached validity
                    # already holds this predicate
                    return RelOut(out.cols, out.valid, runf=None)
                p = pred(ctx.runtime(out.cols))
                keep = p.value
                if p.null is not None:
                    keep = keep & ~p.null
                # run-space bookkeeping for the RLE aggregate lane: the
                # filter stays run-aligned only if THIS predicate reduced
                # in run space over the same run partition as every one
                # before it
                runf = None
                if p.rmask is not None and p.null is None:
                    if out.runf == "pure":
                        runf = (p.rends, p.rmask)
                    elif (isinstance(out.runf, tuple)
                          and out.runf[0] is p.rends):
                        runf = (p.rends, out.runf[1] & p.rmask)
                return RelOut(out.cols, out.valid & keep, runf=runf)

            return run_filter, scope

        if isinstance(plan, ast.Project):
            child, scope = self._emit_rel(plan.child)
            builder = self._builder_for(scope)
            runs = [builder.emit(e) for e in plan.exprs]
            out_scope = [
                _ScopeCol(_expr_name(e), expr_type(e),
                          _derived_dict_provider(e, scope)
                          or _element_dict_provider(e, scope), True)
                for e in plan.exprs]

            def run_project(ctx) -> RelOut:
                out = child(ctx)
                rt = ctx.runtime(out.cols)
                return RelOut({i: r(rt) for i, r in enumerate(runs)},
                              out.valid, runf=out.runf)

            return run_project, out_scope

        if isinstance(plan, ast.Join):
            return self._emit_join(plan)

        raise CompileError(
            f"node {type(plan).__name__} not supported in device region")

    # -- join --------------------------------------------------------------

    def _emit_join(self, plan: ast.Join):
        """General device join: sorted build + searchsorted match RANGES.

        Unique builds (the dimension/PK case) gather their single passing
        match directly on the probe shape; non-unique builds prefix-sum
        the range widths into a bind-time-bucketed expanded output
        (ops/join.expand) — one-to-many/many-to-many inner, left, right
        and full outer all stay on the device.  The sorted build keys +
        stable sort order are a cached artifact keyed on the build's bind
        identity (ops/join.build_artifact), so repeated executions skip
        the sort; query filters on the build side apply through a pass
        mask over the sorted order instead of re-sorting.  Shapes with no
        device lowering reroute to the exact host join via reasoned
        `join_fallback_*` counters.  The reference's mesh pieces (shuffle
        binds, per-shard bounds, distribution metadata) have no
        counterpart on one device."""
        props = self.props
        rel_lo = len(self.relations)
        left, lscope = self._emit_rel(plan.left)
        rel_mid = len(self.relations)
        right, rscope = self._emit_rel(plan.right)
        rel_hi = len(self.relations)
        nleft = len(lscope)
        how = plan.how
        # join relations bind DECODED plates: build artifacts and probe
        # key encodes read flat [B*cap] value layouts (counted
        # compressed_fallback_join_key when a compressible column decodes
        # because of this)
        for r in self.relations[rel_lo:rel_hi]:
            r.allow_code = False

        equi, residual = _split_equi(plan.condition, nleft)
        if not equi:
            _join_reject("non_equi",
                         "non-equi/cross join not supported on device")
        if residual is not None and how != "inner":
            # an ON-clause residual on an outer join NULL-extends failing
            # pairs — the device's post-join filter would DROP them; and
            # semi/anti drop the right columns before the residual could
            # run.  The host path evaluates residuals per candidate pair.
            _join_reject("residual_outer",
                         f"{how} join with residual: host path")
        self.bind_checks.append(
            lambda _p=props: _check_device_join_enabled(_p))

        # -- per-pair key domain: how both sides encode into int64 --------
        enc_spec: List[str] = []
        for li, ri in equi:
            ldt = lscope[li].dtype
            rdt = rscope[ri - nleft].dtype
            if ldt is None or rdt is None:
                _join_reject("untyped_key",
                             "join key without a static type: host path")
            if ldt.name == "string" or rdt.name == "string":
                if ldt.name != rdt.name:
                    _join_reject("string_nonstring_key",
                                 "string vs non-string join key: host path")
                enc_spec.append("raw")
                continue
            l_ex = ldt.name == "decimal" \
                and np.dtype(ldt.device_dtype()).kind == "i"
            r_ex = rdt.name == "decimal" \
                and np.dtype(rdt.device_dtype()).kind == "i"
            if l_ex or r_ex:
                # exact decimals carry SCALED int64 plates — comparable
                # only against the same scale's scaled domain
                if not (l_ex and r_ex and ldt.scale == rdt.scale):
                    _join_reject("decimal_key_mix",
                                 "exact-decimal join key against a "
                                 "different value domain: host path")
                enc_spec.append("raw")
                continue
            lk = np.dtype(ldt.device_dtype())
            rk = np.dtype(rdt.device_dtype())
            if (lk.kind == "f" or rk.kind == "f") and lk != rk:
                # mixed int/float (or f32/f64): compare in float64 —
                # exact for the float side; int sides are bind-checked
                # below to stay under 2^53
                enc_spec.append("f64")
            else:
                enc_spec.append("raw")

        # -- base-source resolution (build AND probe sides) ---------------
        bsources = [self._resolve_join_source(plan.right, ri - nleft,
                                              rel_mid, rel_hi)
                    for _, ri in equi]
        psources = [self._resolve_join_source(plan.left, li,
                                              rel_lo, rel_mid)
                    for li, _ in equi]
        build_rel = build_ords = None
        if all(s is not None for s in bsources) \
                and len({id(s[0]) for s in bsources}) == 1:
            build_rel = bsources[0][0]
            build_ords = tuple(s[2] for s in bsources)
        probe_rel = None
        if all(s is not None for s in psources) \
                and len({id(s[0]) for s in psources}) == 1:
            probe_rel = psources[0][0]

        # mixed int/float exactness: bind-check every INT side's values —
        # a derived int key can't be proven under 2^53
        for pi, (li, ri) in enumerate(equi):
            if enc_spec[pi] != "f64":
                continue
            for side_dt, src in ((lscope[li].dtype, psources[pi]),
                                 (rscope[ri - nleft].dtype, bsources[pi])):
                if np.dtype(side_dt.device_dtype()).kind not in ("i", "u"):
                    continue
                if src is None:
                    _join_reject("mixed_key_unprovable",
                                 "mixed int/float join key on a derived "
                                 "column (2^53 exactness unprovable): "
                                 "host path")
                self.bind_checks.append(
                    lambda _i=src[1], _o=src[2]:
                    _require_f64_exact_int_key(_i, _o))

        # string join keys: each table has its OWN dictionary, so codes
        # are not comparable across tables — translate left codes into
        # the right table's code space via a vectorized LUT (unmatched
        # values -> -1, which equals no real code), cached per dictionary
        # version when both are base-table dictionaries
        str_trans: Dict[int, int] = {}
        trans_getters: Dict[int, Callable] = {}
        for pi, (li, ri) in enumerate(equi):
            lprov = lscope[li].dict_provider
            rprov = rscope[ri - nleft].dict_provider
            if lprov is None or rprov is None:
                continue
            ck = owners = None
            if psources[pi] is not None and bsources[pi] is not None:
                ck = ("trans", id(psources[pi][1].data), psources[pi][2],
                      id(bsources[pi][1].data), bsources[pi][2])
                owners = (psources[pi][1].data, bsources[pi][1].data)

            def trans_of(_lp=lprov, _rp=rprov, _ck=ck, _ow=owners):
                return _dj.translate_codes(_lp(), _rp(), cache_key=_ck,
                                           owners=_ow)

            self.aux_builders.append(lambda params, _t=trans_of: _t())
            str_trans[pi] = len(self.aux_builders) - 1
            trans_getters[pi] = trans_of

        artifact_mode = build_rel is not None
        if not artifact_mode and how not in ("semi", "anti"):
            # semi/anti only need membership (any build works, sorted per
            # execution); everything else needs the artifact's uniqueness
            # verdict / expansion bound, both of which read base columns
            _join_reject("derived_build",
                         "join build side is a derived relation: "
                         "host path")

        # a build side with NO query filter keeps every row of a real
        # key's sorted run live (dead/NULL rows are key-sentineled to the
        # end) — the dense range math skips the pass prefix-sum and its
        # per-execution searchsorteds (the hot Q3-class shape)
        def _has_filter(p: ast.Plan) -> bool:
            return isinstance(p, ast.Filter) \
                or any(_has_filter(k) for k in p.children())

        build_filtered = _has_filter(plan.right)

        art_aux = None
        artifact_of = None
        if artifact_mode:
            build_rel.no_skip = True  # order indexes the FULL flat layout
            enc_sig = tuple(enc_spec)

            def artifact_of(_rel=build_rel, _ords=build_ords,
                            _sig=enc_sig):
                dt = _rel.bound()

                def compute():
                    pairs = []
                    anynull = None
                    for ci, spec in zip(_ords, _sig):
                        v = dt.columns[ci].reshape(-1)
                        nl = dt.nulls.get(ci)
                        nl = nl.reshape(-1) if nl is not None else None
                        if spec == "f64":
                            v = v.to(torch.float64)
                        pairs.append((v, nl))
                        anynull = _or_null(anynull, nl)
                    return _dj.encode_build_keys(
                        pairs, dt.valid.reshape(-1), anynull)

                return _dj.build_artifact(dt.valid, (_ords, _sig), compute)

            # _bind evaluates aux builders BEFORE static providers, so
            # stashing the artifact here lets mode_provider reuse it —
            # otherwise a cache-disabled (or over-budget) bind pays the
            # build sort + uniqueness read TWICE per execution
            art_tls = threading.local()

            def _aux_artifact(params):
                art = artifact_of()
                if how not in ("semi", "anti"):
                    # mode_provider is the stash's only consumer
                    art_tls.art = art
                return art["skeys"], art["order"]

            self.aux_builders.append(_aux_artifact)
            art_aux = len(self.aux_builders) - 1

        mode_si = bucket_si = None
        if artifact_mode and how not in ("semi", "anti"):
            tls = threading.local()
            null_extend = how in ("left", "full")

            def _row_width() -> int:
                """Approximate bytes per expanded output row (value +
                null byte per used column of both sides + the mask)."""
                w = 1
                for r in (probe_rel, build_rel):
                    if r is None:
                        continue
                    for ci in r.used:
                        f = r.info.schema.fields[ci]
                        w += np.dtype(f.dtype.device_dtype()).itemsize + 1
                return w

            def _check_expand_cap(slots: int) -> None:
                cap = int(props.get("join_expand_max_bytes", 0) or 0)
                est = slots * _row_width()
                if cap and est > cap:
                    _warn_expand_cap(est, cap)
                    _join_reject(
                        "expand_bytes",
                        f"join expansion needs ~{est:,} bytes > "
                        f"join_expand_max_bytes={cap:,}: host path")

            def mode_provider() -> int:
                reg = global_registry()
                art = getattr(art_tls, "art", None)
                art_tls.art = None  # consume: never reuse across binds
                if art is None:
                    art = artifact_of()
                # right/full outer appends F build-extension slots (one
                # per build flat row) to every output column — they count
                # against the byte cap exactly like expansion slots
                fext = int(art["skeys"].shape[0]) \
                    if how in ("right", "full") else 0
                # join_device_joins counts only once the bind can no
                # longer reject: a reroute below must not ALSO count as
                # a device join
                if art["unique"]:
                    if fext:
                        probe_slots = probe_rel.bound().valid.numel() \
                            if probe_rel is not None else 0
                        _check_expand_cap(probe_slots + fext)
                    tls.bucket = 0
                    reg.inc("join_device_joins")
                    return 0
                if probe_rel is None:
                    _join_reject(
                        "derived_probe_nonunique",
                        "one-to-many join with a derived probe side "
                        "(expansion bound unprovable): host path")
                dtp = probe_rel.bound()

                def compute_pkeys():
                    pairs = []
                    anynull = None
                    for pi2, (s, spec) in enumerate(
                            zip(psources, enc_spec)):
                        v = dtp.columns[s[2]].reshape(-1)
                        nl = dtp.nulls.get(s[2])
                        nl = nl.reshape(-1) if nl is not None else None
                        getter = trans_getters.get(pi2)
                        if getter is not None:
                            trans = torch.from_numpy(getter()).to(v.device)
                            v = trans[v.long().clamp(0, trans.shape[0] - 1)]
                        if spec == "f64":
                            v = v.to(torch.float64)
                        pairs.append((v, nl))
                        anynull = _or_null(anynull, nl)
                    return (_dj.encode_probe_keys(pairs, anynull),
                            dtp.valid.reshape(-1))

                bound = _dj.probe_expand_bound(
                    art, dtp.valid, tuple(s[2] for s in psources),
                    null_extend, compute_pkeys)
                bucket = _dj.expand_bucket(max(1, bound))
                _check_expand_cap(bucket + fext)
                reg.inc("join_device_joins")
                reg.inc("join_expand_out_rows", bucket)
                reg.inc("join_expand_probe_rows",
                        max(1, int(dtp.total_rows)))
                tls.bucket = bucket
                return 1

            mode_si = self._add_static(mode_provider)
            # registered AFTER mode_provider: _bind evaluates statics in
            # order, so the thread-local bucket is always fresh
            bucket_si = self._add_static(
                lambda: int(getattr(tls, "bucket", 0)))
        else:
            self.bind_checks.append(_count_device_join)

        if how in ("semi", "anti"):
            out_scope = [_ScopeCol(s.name, s.dtype, s.dict_provider,
                                   s.nullable) for s in lscope]
        else:
            lnul = how in ("right", "full")
            rnul = how in ("left", "full")
            out_scope = [_ScopeCol(s.name, s.dtype, s.dict_provider,
                                   True if lnul else s.nullable)
                         for s in lscope] + \
                        [_ScopeCol(s.name, s.dtype, s.dict_provider,
                                   True if rnul else s.nullable)
                         for s in rscope]
        residual_run = self._builder_for(lscope + rscope).emit(residual) \
            if residual is not None else None

        def run_join(ctx) -> RelOut:
            lo = left(ctx)
            ro = right(ctx)
            dev = ctx.device
            lpairs = [lo.cols[k] for k, _ in equi]
            rpairs = [ro.cols[k - nleft] for _, k in equi]
            # translate left string codes into right code space first
            for pi, aux_i in str_trans.items():
                trans = ctx.aux[aux_i]
                lv = lpairs[pi]
                codes = lv.value.long().clamp(0, trans.shape[0] - 1)
                lpairs[pi] = DVal(trans[codes], lv.null, lv.dtype)
            # mixed-domain pairs compare in float64 (bind-checked exact)
            for pi, spec in enumerate(enc_spec):
                if spec == "f64":
                    a, b = lpairs[pi], rpairs[pi]
                    lpairs[pi] = DVal(a.value.to(torch.float64), a.null,
                                      a.dtype)
                    rpairs[pi] = DVal(b.value.to(torch.float64), b.null,
                                      b.dtype)
            # probe keys on the probe row shape; NULL keys get a sentinel
            # absent from the build (NULL never matches — SQL semantics)
            lpairs = [DVal(_broadcast_to_mask(d.value, lo.valid),
                           _broadcast_to_mask(d.null, lo.valid)
                           if d.null is not None else None, d.dtype)
                      for d in lpairs]
            pnull = None
            for d in lpairs:
                pnull = _or_null(pnull, d.null)
            pkeys = _combine_keys(lpairs)
            if pnull is not None:
                pkeys = torch.where(pnull, _dj.PROBE_NULL_SENTINEL, pkeys)

            pass_flat = ro.valid.reshape(-1)
            if artifact_mode:
                skeys, order = ctx.aux[art_aux]
                if build_filtered:
                    # the artifact sorts the FULL snapshot; query filters
                    # on the build side apply through this pass mask
                    # instead of a re-sort
                    counts, basec, cum = _dj.match_ranges(
                        skeys, order, pass_flat, pkeys)

                    def locate(b, r):
                        return _dj.nth_match(b, r, cum, order)
                else:
                    counts, basec = _dj.match_ranges_dense(skeys, pkeys)

                    def locate(b, r):
                        return _dj.nth_match_dense(b, r, order)
            else:
                # derived build (semi/anti): sort per execution — the key
                # sentinel already excludes filtered/NULL/dead rows
                # (ro.valid carries the build filter), so the dense range
                # math applies
                rflat = [(_broadcast_to_mask(d.value, ro.valid).reshape(-1),
                          _broadcast_to_mask(d.null, ro.valid).reshape(-1)
                          if d.null is not None else None) for d in rpairs]
                bnull = None
                for _v, nl in rflat:
                    bnull = _or_null(bnull, nl)
                bkeys = _dj.encode_build_keys(rflat, pass_flat, bnull)
                skeys, order = torch.sort(bkeys, stable=True)
                counts, basec = _dj.match_ranges_dense(skeys, pkeys)

                def locate(b, r):
                    return _dj.nth_match_dense(b, r, order)
            found = counts > 0
            if how == "semi":
                return RelOut(dict(lo.cols), lo.valid & found)
            if how == "anti":
                return RelOut(dict(lo.cols), lo.valid & ~found)

            if ctx.static[mode_si] == 0 and how in ("inner", "left"):
                # unique build: at most ONE passing match per probe row —
                # direct gather on the probe shape, no expansion
                bpos = locate(basec, 0)
                cols: Dict[int, DVal] = dict(lo.cols)
                for i in sorted(ro.cols):
                    src = ro.cols[i]
                    gv = _broadcast_to_mask(src.value, ro.valid) \
                        .reshape(-1)[bpos]
                    gnull = None
                    if src.null is not None:
                        gnull = _broadcast_to_mask(src.null, ro.valid) \
                            .reshape(-1)[bpos]
                    if how == "left":
                        gnull = _or_null(gnull, ~found)
                    cols[nleft + i] = DVal(gv, gnull, src.dtype,
                                           src.dictionary)
                valid = lo.valid & found if how == "inner" else lo.valid
                out = RelOut(cols, valid)
            else:
                # one-to-many expansion (and right/full NULL-extension of
                # unmatched build rows): FLAT bucketed output
                pvalid_flat = lo.valid.reshape(-1)
                counts_f = torch.where(pvalid_flat, counts.reshape(-1), 0)
                base_f = basec.reshape(-1)
                bucket = ctx.static[bucket_si] \
                    if ctx.static[mode_si] == 1 \
                    else int(pvalid_flat.shape[0])
                if how in ("left", "full"):
                    # unmatched (or NULL-key) probe rows keep one slot
                    counts_eff = torch.where(pvalid_flat,
                                             counts_f.clamp(min=1), 0)
                else:
                    counts_eff = counts_f
                probe_of, rank, matched, slot_valid, total = _dj.expand(
                    counts_f, counts_eff, bucket)
                bpos = locate(base_f[probe_of], rank)
                del rank, counts_eff, base_f
                # filters only shrink the bound, so this can fire only on
                # a probe/build mutation racing the bind — reroute to the
                # exact host path rather than drop rows silently
                ctx.note_overflow(total > bucket)
                ext = how in ("right", "full")
                F = int(order.shape[0])

                def flat_pair(dv, mask2d):
                    v = _broadcast_to_mask(dv.value, mask2d).reshape(-1)
                    nl = _broadcast_to_mask(dv.null, mask2d).reshape(-1) \
                        if dv.null is not None else None
                    return v, nl

                def falses(k):
                    return torch.zeros(k, dtype=torch.bool, device=dev)

                cols = {}
                for i in sorted(lo.cols):
                    dv = lo.cols[i]
                    v, nl = flat_pair(dv, lo.valid)
                    gv = v[probe_of]
                    gnull = nl[probe_of] if nl is not None else None
                    if ext:  # build-extension slots: left side is NULL
                        gv = torch.cat([gv, torch.zeros(F, dtype=gv.dtype,
                                                        device=dev)])
                        gnull = torch.cat(
                            [gnull if gnull is not None else falses(bucket),
                             torch.ones(F, dtype=torch.bool, device=dev)])
                    cols[i] = DVal(gv, gnull, dv.dtype, dv.dictionary)
                ext_valid = None
                if ext:
                    # mark build rows consumed by a matched slot; the
                    # rest NULL-extend (right/full outer).  Unmatched
                    # slots scatter into the extra slot F, sliced off.
                    consumed = falses(F + 1)
                    consumed[torch.where(matched, bpos, F)] = True
                    ext_valid = pass_flat & ~consumed[:F]
                for i in sorted(ro.cols):
                    src = ro.cols[i]
                    v, nl = flat_pair(src, ro.valid)
                    gv = v[bpos]
                    gnull = nl[bpos] if nl is not None else None
                    if how in ("left", "full"):
                        gnull = _or_null(gnull, ~matched)
                    if ext:
                        gv = torch.cat([gv, v])
                        gnull = torch.cat(
                            [gnull if gnull is not None else falses(bucket),
                             nl if nl is not None else falses(F)])
                    cols[nleft + i] = DVal(gv, gnull, src.dtype,
                                           src.dictionary)
                valid = slot_valid
                if ext:
                    valid = torch.cat([valid, ext_valid])
                out = RelOut(cols, valid)
            if residual_run is not None:
                p = residual_run(ctx.runtime(out.cols))
                keep = p.value
                if p.null is not None:
                    keep = keep & ~p.null
                out = RelOut(out.cols, out.valid & keep)
            return out

        return run_join, out_scope

    def _resolve_join_source(self, plan: ast.Plan, ordinal: int,
                             rel_lo: int, rel_hi: int):
        """Resolve a join-side scope ordinal to (_RelationInput, TableInfo,
        base ordinal) — the leaf whose device plates the build artifact /
        expansion bound read.  None when the column is derived, spans a
        nested join, or the side references the same base table more
        than once (ambiguous)."""
        got = self._resolve_build_source(plan, ordinal)
        if got is None:
            return None
        info, ci = got
        rels = [r for r in self.relations[rel_lo:rel_hi] if r.info is info]
        if len(rels) != 1:
            return None
        return rels[0], info, ci

    def _resolve_build_source(self, plan: ast.Plan, ordinal: int
                              ) -> Optional[Tuple[object, int]]:
        """Map a join-side scope ordinal to its base (TableInfo, schema
        ordinal), following filters/aliases/plain-column projections.
        Filters only REMOVE rows, so uniqueness of the base column implies
        uniqueness of the filtered build side.  None = unprovable."""
        if isinstance(plan, (ast.SubqueryAlias, ast.Filter)):
            return self._resolve_build_source(plan.child, ordinal)
        if isinstance(plan, ast.Relation):
            info = self.catalog.lookup_table(plan.name)
            return None if info is None else (info, ordinal)
        if isinstance(plan, ast.Project):
            e = plan.exprs[ordinal]
            if isinstance(e, ast.Alias):
                e = e.child
            if isinstance(e, ast.Col) and e.index is not None:
                return self._resolve_build_source(plan.child, e.index)
            return None
        return None

    def _emit_aggregate(self, plan: ast.Aggregate):
        child, scope = self._emit_rel(plan.child)
        builder = self._builder_for(scope)
        props = self.props

        groups = list(plan.group_exprs)
        key_runs = [builder.emit(g) for g in groups]

        # the single base COLUMN table behind a Filter*/alias* chain: the
        # shape whose direct numeric keys can group in code space (vdict)
        inner = plan.child
        while isinstance(inner, (ast.SubqueryAlias, ast.Filter)):
            inner = inner.child
        base_info = self.relations[-1].info \
            if isinstance(inner, ast.Relation) and self.relations else None
        # the rle_agg reroute is tallied per table too (the compactor's
        # trigger); a weak reference, so a cached plan keeps no table
        base_table_ref = weakref.ref(base_info.data) \
            if base_info is not None else None

        # collect primitive agg slots (decomposing avg -> sum + count)
        slots: List[Tuple[str, Optional[ast.Expr]]] = []

        def slot_of(kind: str, arg: Optional[ast.Expr]) -> int:
            key = (kind, arg)
            for i, s in enumerate(slots):
                if s == key:
                    return i
            slots.append(key)
            return len(slots) - 1

        def rewrite(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ast.Func) and e.name in ast.AGG_FUNCS:
                arg = e.args[0] if e.args else None
                if arg is not None and e.name not in _COUNT_AGGS \
                        and expr_type(arg).name == "string":
                    raise CompileError(
                        f"{e.name} over a string: host path")
                if e.name == "count":
                    return _SlotRef(slot_of("count", arg), T.LONG)
                if e.name in ("count_distinct", "approx_count_distinct"):
                    return _SlotRef(slot_of("count_distinct", arg), T.LONG)
                if e.name == "sum":
                    return _SlotRef(slot_of("sum", arg), expr_type(e))
                if e.name in ("min", "max", "first", "last"):
                    kind = {"first": "min", "last": "max"}.get(e.name, e.name)
                    return _SlotRef(slot_of(kind, arg), expr_type(arg))
                if e.name == "avg":
                    # the sum slot may be shared with an explicit sum(x):
                    # for exact decimals it holds scaled int64, so the
                    # slot ref carries the decimal type and the division
                    # unscales (avg = exact sum / count)
                    at = expr_type(arg) if arg is not None else T.DOUBLE
                    st = T.decimal_sum_type(at) if at.name == "decimal" \
                        else T.DOUBLE
                    s = _SlotRef(slot_of("sum", arg), st)
                    c = _SlotRef(slot_of("count", arg), T.LONG)
                    return ast.BinOp("/", s, c)
                if e.name in ("stddev", "variance"):
                    if arg is not None \
                            and expr_type(arg).name == "decimal":
                        # sumsq would square the SCALED representation:
                        # run these moments in the plain float domain
                        arg = ast.Cast(arg, T.DOUBLE)
                    s = _SlotRef(slot_of("sum", arg), T.DOUBLE)
                    s2 = _SlotRef(slot_of("sumsq", arg), T.DOUBLE)
                    c = _SlotRef(slot_of("count", arg), T.LONG)
                    mean = ast.BinOp("/", s, c)
                    var = ast.BinOp("-", ast.BinOp("/", s2, c),
                                    ast.BinOp("*", mean, mean))
                    if e.name == "variance":
                        return var
                    return ast.Func("sqrt", (var,))
                raise CompileError(
                    f"aggregate {e.name} is not ported to the device path")
            # group expression structural match -> key ref
            for gi, g in enumerate(groups):
                if e == g:
                    return _KeyRef(gi, expr_type(g))
            return e.map_children(rewrite)

        select_rewritten = [rewrite(e.child if isinstance(e, ast.Alias)
                                    else e) for e in plan.agg_exprs]
        slot_arg_runs = [builder.emit(arg) if arg is not None else None
                         for _, arg in slots]

        def _slot_dtype(kind: str, arg) -> T.DataType:
            """Static type of a slot's [G] tensor: the post-agg scope
            needs it so exact-decimal slot values (scaled int64) meet the
            decimal-aware expression lowering."""
            if kind in ("count", "count_distinct"):
                return T.LONG
            if kind == "sumsq":
                return T.DOUBLE
            at = expr_type(arg) if arg is not None else T.DOUBLE
            if kind == "sum":
                return T.decimal_sum_type(at) if at.name == "decimal" \
                    else at
            return at  # min / max

        slot_dtypes = [_slot_dtype(k, a) for k, a in slots]

        # key cardinalities (static): string keys use the padded dict size
        key_infos = []
        for g in groups:
            gt = expr_type(g)
            base_g = g.child if isinstance(g, ast.Alias) else g
            if gt.name == "string":
                provider = _derived_dict_provider(g, scope)
                if provider is None:
                    raise CompileError(
                        "string group key without a dictionary: host path")
                if not isinstance(base_g, ast.Col):
                    # grouping is by CODE: a non-injective derived value
                    # map (upper() folding 'a' and 'A') would split one
                    # group in two — checked at every bind, host path if so
                    provider = _unique_dict_or_host(provider)
                si = self._add_static(
                    lambda p=provider: _padded_size(len(p())))
                key_infos.append(("dict", si, provider))
            elif gt.name == "boolean":
                key_infos.append(("bool", None, None))
            elif (base_info is not None and isinstance(base_g, ast.Col)
                  and not isinstance(base_info.data, RowTableData)
                  and base_g.index is not None and gt.name != "decimal"
                  and T.is_numeric(gt)):
                # vdict: a direct numeric key of a base column table
                # groups through its table-global sorted value domain.
                # The domain declines per bind (cardinality / NaN), which
                # pushes the static card past max_groups -> generic lane
                data, ci, mg = base_info.data, base_g.index, \
                    props.max_groups
                vd = (lambda d=data, c=ci, m=mg:
                      numeric_key_domain(d, c, m))
                si = self._add_static(lambda p=vd, m=mg: _vdict_card(p(), m))
                aux_ix = len(self.aux_builders)
                self.aux_builders.append(lambda params, p=vd: _vdict_lut(p()))
                key_infos.append(("vdict", si, (vd, aux_ix)))
            else:
                # generic hash-key lane: derived keys, keys above a join
                key_infos.append(("generic", None, None))

        max_groups = props.max_groups
        partial_raw = self.partial_raw

        # direct-column keys + forced NULL extension: in partial-raw mode
        # a nullable base-column key claims its extra NULL code slot even
        # when the bound plate carries no null mask — whether a window of
        # the table holds NULLs is data-dependent, and the tiled merge
        # needs every tile to agree on the group-index space
        key_direct: List[bool] = []
        key_force_null: List[bool] = []
        for g in groups:
            base = g.child if isinstance(g, ast.Alias) else g
            direct = isinstance(base, ast.Col) and base.index is not None
            key_direct.append(direct)
            key_force_null.append(bool(partial_raw and direct
                                       and scope[base.index].nullable))

        strategy_si = self._add_static(lambda p=props: _strategy_token(p))
        code_agg_si = self._add_static(lambda p=props: _code_agg_token(p))
        # run-space readiness rides the static key too: a DELETE's mask
        # re-specializes the plan off the run lane, no cache flush
        rle_gate_si = self._add_static(
            lambda d=base_info.data: _rle_agg_ready(d)) \
            if base_info is not None else None
        kernel_si = self._add_static(_kernel_token)
        notes = self._agg_notes = {}

        # post-aggregation expression evaluation over [G] arrays
        out_types = [expr_type(e) for e in plan.agg_exprs]
        post_scope_types: Dict[int, T.DataType] = {}
        post_dicts: Dict[int, Callable] = {}
        for gi, g in enumerate(groups):
            post_scope_types[gi] = expr_type(g)
            if expr_type(g).name == "string":
                post_dicts[gi] = key_infos[gi][2]
        post_builder = self._new_builder(post_scope_types, {}, post_dicts)
        post_runs = [post_builder.emit(_slots_to_cols(e, len(groups)))
                     for e in select_rewritten]

        out_cols = []
        for e_out, e_rw, dt in zip(plan.agg_exprs, select_rewritten,
                                   out_types):
            provider = None
            if dt.name == "string" and isinstance(e_rw, _KeyRef):
                provider = key_infos[e_rw.key][2]
            out_cols.append(OutCol(_expr_name(e_out), dt, provider))

        # scan-tile scale: under scan_tile_bytes tiling each execution
        # sees one window of the table, and the exact-decimal sum
        # overflow guard must bound the MERGED total across all tiles —
        # per-tile bounds can each pass while the int64 partial-merge
        # total wraps.  1.0 outside a tile pass.  Registered only where
        # a slot can take the exact int64 sum lane.
        tile_scale_aux = None
        if any(k == "sum" and a is not None
               and _is_exact_decimal(expr_type(a)) for k, a in slots):
            tile_scale_aux = len(self.aux_builders)
            rel_inputs = list(self.relations)

            def _tile_scale(params, _rels=rel_inputs):
                scale = 1.0
                for r in _rels:
                    scale = max(scale, current_scan_scale(r.info.data))
                return np.array(scale, dtype=np.float64)

            self.aux_builders.append(_tile_scale)

        # partial-raw merge metadata: one merge op per output column so
        # the tiled scan can fold per-tile [G] partials on the device.
        # Only sound when every output is a bare key/slot ref and every
        # key is a direct dict/bool/vdict column — data-independent cards
        # mean every tile shares one aligned group-index space.
        if partial_raw:
            tags: List[tuple] = []
            merge_ok = True
            for e_rw in select_rewritten:
                if isinstance(e_rw, _KeyRef):
                    tags.append(("key", e_rw.key))
                elif isinstance(e_rw, _SlotRef):
                    op = {"count": "sum", "sum": "sum", "sumsq": "sum",
                          "min": "min", "max": "max"}.get(
                              slots[e_rw.slot][0])
                    if op is None:
                        merge_ok = False
                    tags.append(("slot", op))
                else:
                    merge_ok = False
            for ki, (kind, _si, _prov) in enumerate(key_infos):
                if kind == "generic" or not key_direct[ki]:
                    merge_ok = False
            if merge_ok:
                def _cards_total(_infos=list(key_infos),
                                 _force=list(key_force_null)) -> int:
                    total = 1
                    for (kind, _si, prov), force in zip(_infos, _force):
                        if kind == "bool":
                            card = 2
                        elif kind == "vdict":
                            card = _vdict_card(prov[0](), max_groups)
                        else:
                            card = _padded_size(len(prov()))
                        total *= card + (1 if force else 0)
                    return total

                self._tile_merge = {"tags": tags, "cards": _cards_total,
                                    "max_groups": max_groups}

        def shape_info(ctx, kdvals):
            """(fast, cards, eff_cards, num_groups): the mixed-radix fast
            path when every key is dict/bool/vdict and their product fits
            max_groups; otherwise the generic lane, whose group count is
            the data's (num_groups None until group_index finds it)."""
            cards = []
            fast = True
            for (kind, si, _) in key_infos:
                if kind in ("dict", "vdict"):
                    cards.append(ctx.static[si])
                elif kind == "bool":
                    cards.append(2)
                else:
                    fast = False
                    cards.append(None)
            # NULL group keys form their own group: a nullable key gets
            # one extra code slot = card (partial-raw forces the slot for
            # nullable base columns, see key_force_null)
            eff_cards = [c + 1 if c is not None
                         and (kd.null is not None or force) else c
                         for c, kd, force in zip(cards, kdvals,
                                                 key_force_null)]
            if fast and int(np.prod(eff_cards)) <= max_groups:
                return True, cards, eff_cards, int(np.prod(eff_cards))
            return False, cards, eff_cards, None

        def generic_index(ctx, kdvals, out, valid):
            """Generic hash-key lane: (gidx, num_groups).  Keys combine
            into one int64 (ops/join.combine_key_arrays), invalid rows
            take the sentinel, the sorted unique keys number the groups
            and a searchsorted assigns each row its group.  Past
            max_groups the overflow flag rises (the executor reruns the
            plan on the exact host path) and the group space truncates
            to max_groups, bounding the wasted work."""
            combined = _combine_keys(
                [DVal(_broadcast_to_mask(k.value, out.valid).reshape(-1),
                      _broadcast_to_mask(k.null, out.valid).reshape(-1)
                      if k.null is not None else None, k.dtype)
                 for k in kdvals])
            combined = torch.where(valid, combined, _dj.I64_MAX)
            uniq = torch.unique(combined, sorted=True)
            # the sentinel sorts last; what precedes it are the real keys
            n_real = uniq.shape[0] - int(uniq[-1] == _dj.I64_MAX)
            if n_real > max_groups:
                ctx.note_overflow(True)
                n_real = max_groups
            uniq = uniq[:n_real]
            num_groups = max(1, n_real)
            gidx = torch.searchsorted(uniq, combined)
            return torch.where(valid, gidx, num_groups) \
                .to(torch.int32), num_groups

        def group_index(ctx, kdvals, out, valid, cards, eff_cards,
                        num_groups):
            """Combined int32 group index; invalid rows point at the
            overflow segment num_groups."""
            n = valid.shape[0]
            dev = ctx.device
            if not groups:
                return torch.where(valid, 0, 1).to(torch.int32)
            gidx = torch.zeros(n, dtype=torch.int64, device=dev)
            for kd, card, ecard, ki in zip(kdvals, cards, eff_cards,
                                           key_infos):
                if ki[0] == "vdict":
                    # group index straight from the table-global value
                    # domain: a code plate remaps its per-batch CODES
                    # through the domain (value plate never gathered);
                    # anything else searchsorts its values
                    gd = ctx.aux[ki[2][1]]
                    if (kd.cplate is not None
                            and ctx.static[code_agg_si] != 0):
                        remap = torch.searchsorted(
                            gd, kd.cplate.dicts.to(gd.dtype).contiguous())
                        kv = torch.gather(remap, 1,
                                          kd.cplate.codes.long()).reshape(-1)
                    else:
                        vals = _broadcast_to_mask(kd.value, out.valid) \
                            .reshape(-1).to(gd.dtype).contiguous()
                        kv = torch.searchsorted(gd, vals)
                else:
                    kv = _broadcast_to_mask(kd.value, out.valid) \
                        .reshape(-1).long()
                if kd.null is not None:
                    nb = _broadcast_to_mask(kd.null, out.valid).reshape(-1)
                    kv = torch.where(nb, card, kv)
                gidx = gidx * ecard + kv
            # int32: num_groups <= max_groups (65536) always fits
            return torch.where(valid, gidx, num_groups).to(torch.int32)

        def compute_pre(ctx, out, kdvals):
            """(valid, gidx, num_groups, fast, cards, eff_cards): the
            filtered validity and the combined group index, the cacheable
            prefix of every grouped aggregate."""
            valid = out.valid.reshape(-1)
            if groups:
                fast, cards, eff_cards, num_groups = shape_info(ctx, kdvals)
            else:
                fast, cards, eff_cards, num_groups = True, [], [], 1
            if fast:
                gidx = group_index(ctx, kdvals, out, valid, cards,
                                   eff_cards, num_groups)
            else:
                gidx, num_groups = generic_index(ctx, kdvals, out, valid)
            return valid, gidx, num_groups, fast, cards, eff_cards

        def fsum_strategy_of(ctx, n, num_groups) -> str:
            return reduction.resolve_strategy(
                reduction.STRATEGIES[ctx.static[strategy_si]],
                ctx.device.type, num_groups, n, "fsum", torch.float64)

        def run_pre(ctx) -> "_PreEntry":
            """Phase A: the filtered validity, the group index, the group
            count and the overflow flag: the group-index cache's entry.
            The one-hot joins the entry where the matmul strategy takes it
            (phase B attaches the one it builds, `_pre_cache_attach`): a
            plan whose float sums all ride the grouped kernel never
            builds one.  The child's output stays on the context, so a
            miss's phase B does not evaluate the child a second time."""
            out = child(ctx)
            rt = ctx.runtime(out.cols)
            kdvals = [kr(rt) for kr in key_runs]
            valid, gidx, num_groups, _f, _c, _e = compute_pre(
                ctx, out, kdvals)
            if valid.untyped_storage().data_ptr() == \
                    ctx.rels[0][1].untyped_storage().data_ptr():
                # no filter: the validity IS the bound table's mask, and
                # the entry must hold only its own tensors
                valid = valid.clone()
            ctx.pre_state = (out, rt, kdvals)
            return _PreEntry(valid, gidx, num_groups, ctx.overflow, None)

        def run_agg(ctx, pre: Optional["_PreEntry"] = None) -> tuple:
            state = getattr(ctx, "pre_state", None)
            if state is not None:       # phase B right after a miss
                out, rt, kdvals = state
                ctx.pre_state = None
            else:
                # a hit skips the filters: the cached validity replaces
                # what they would compute
                ctx.skip_filters = pre is not None
                try:
                    out = child(ctx)
                finally:
                    ctx.skip_filters = False
                rt = ctx.runtime(out.cols)
                kdvals = [kr(rt) for kr in key_runs]
            dev = ctx.device
            if pre is None:
                valid, gidx, num_groups, fast, cards, eff_cards = \
                    compute_pre(ctx, out, kdvals)
                onehot = None
            else:
                valid, gidx, num_groups, onehot = \
                    pre.valid, pre.gidx, pre.num_groups, pre.onehot
                if pre.overflow is not None:
                    ctx.note_overflow(pre.overflow)
                fast, cards, eff_cards, _ng = shape_info(ctx, kdvals) \
                    if groups else (True, [], [], 1)
                out = RelOut(out.cols, valid.reshape(out.valid.shape),
                             runf=None)
            n = valid.shape[0]
            nseg = num_groups + 1
            req = reduction.STRATEGIES[ctx.static[strategy_si]]
            backend = dev.type
            fsum_strat = fsum_strategy_of(ctx, n, num_groups)
            note = {"passes": 0, "strategies": set(), "lanes": set(),
                    "rle_fallbacks": 0}
            tok = ctx.static[code_agg_si]
            # dictionary-space SUM is a scatter-heavy lane: auto keeps it
            # off the CPU; "on" forces it everywhere, "off" kills it.  The
            # run-space lane is cheap arithmetic: only "off" disables it.
            code_agg_on = tok == 2 or (tok == 1 and dev.type != "cpu")
            rle_ok = tok != 0 and base_info is not None \
                and bool(ctx.static[rle_gate_si]) \
                and out.valid.dim() == 2
            if groups and fast and any(ki[0] in ("dict", "vdict")
                                       for ki in key_infos):
                note["lanes"].add("code_domain")
            kbits = ctx.static[kernel_si]

            # --- slots ---
            # Evaluate slot inputs once, dedup by argument expression:
            # slots over the SAME argument (avg's sum + count beside an
            # explicit sum) share one _SlotInput, so its row values are
            # one tensor OBJECT and the grouped kernel's id()-keyed input
            # dedup fires
            evaluated: List[Tuple[str, _SlotInput]] = []
            arg_vw: Dict[object, _SlotInput] = {}
            for (kind, arg), run in zip(slots, slot_arg_runs):
                if run is None:  # count(*)
                    evaluated.append(("count", _SlotInput(None, out.valid,
                                                          valid, False)))
                    continue
                hit = arg_vw.get(arg)
                if hit is None:
                    dv = run(rt)
                    w = valid
                    if dv.null is not None:
                        w = w & ~_broadcast_to_mask(
                            dv.null, out.valid).reshape(-1)
                    # only bare columns carry their code / run plates: an
                    # expression over a plate is row-space math.  Bare
                    # stored columns are also finite on excluded and
                    # padded rows (zero-initialized plates), which lets
                    # the matmul lane skip their pre-mask
                    hit = arg_vw[arg] = _SlotInput(
                        dv, out.valid, w, isinstance(arg, ast.Col))
                evaluated.append((kind, hit))

            def dict_space_ok(kind, si) -> bool:
                cpl = si.cpl
                return (kind == "sum" and cpl is not None and code_agg_on
                        and _acc_dtype(si.sdt, si.vdtype) != torch.int64
                        and code_agg.dict_space_cells(
                            nseg, cpl.codes.shape, cpl.dicts.shape)
                        <= code_agg.DICT_SPACE_MAX_CELLS)

            def run_space(kind, si):
                """The per-run survivor mask when the run-space lane takes
                this global COUNT/SUM over a bare RLE column, else None;
                an eligible plate whose filter left run space is a
                COUNTED fallback, never silent."""
                if not (rle_ok and si.rpl is not None and not groups
                        and si.w is valid):
                    return None
                if kind == "sum" and _acc_dtype(si.sdt, si.vdtype) \
                        == torch.int64:
                    return None   # exact int64 sums stay row-space
                rm = _rle_run_mask(out.runf, si.rpl)
                if rm is None:
                    note["rle_fallbacks"] += 1
                    return None
                # batch-skip pad batches duplicate a real plate under an
                # all-False validity row: mask whole dead batches out
                return rm & out.valid.any(dim=1)[:, None]

            # Fused grouped kernel (the Q1 shape): dictionary/vdict fast
            # path group index, nseg <= 64, f32 value plates — eligible
            # slots share ONE streaming pass with per-thread Kahan
            # partials in shared memory (ops/group_reduce.py).  The
            # shared-memory budget stops fusing before a block would need
            # more than an SM offers; overflow slots take the packed
            # families below.  Identical slots share one kernel chain, so
            # only distinct ones are charged.
            use_gk = bool(groups) and fast and nseg <= _gr.MAX_GROUPS \
                and bool(kbits & 2)
            gk_bytes = _gr.op_smem_bytes("count", nseg)  # the gvalid count
            gk_keys = {_gr.op_key(("count", None, valid))}
            fused = []  # (slot_idx, kind, values|None, mask)
            if use_gk:
                for i, (kind, si) in enumerate(evaluated):
                    eligible = kind == "count" or (
                        kind in ("sum", "min", "max")
                        and si.vdtype == torch.float32)
                    if not eligible or dict_space_ok(kind, si):
                        # the dictionary-space lane below takes a sum
                        # whose column is code-resident
                        continue
                    op = (kind, None if kind == "count" else si.v, si.w)
                    key = _gr.op_key(op)
                    if key not in gk_keys:
                        cost = _gr.op_smem_bytes(kind, nseg)
                        if gk_bytes + cost > _gr.SMEM_BUDGET \
                                or len(gk_keys) >= _gr.MAX_OPS:
                            continue
                        gk_bytes += cost
                        gk_keys.add(key)
                    fused.append((i,) + op)
            fused_idx = {f[0] for f in fused}

            # Packed accumulator families: every remaining slot joins one
            # [N, S] matrix per family, reduced in ONE dispatch
            slot_arrays: List = [None] * len(slots)
            fsum_cols: List[tuple] = []     # (slot idx, f64 contrib)
            count_ws: List = []             # unique count masks
            count_of: Dict[int, int] = {}   # id(mask) -> column
            count_users: List[tuple] = []   # (slot idx, column)
            isum_cols: List[tuple] = []     # (slot idx, int64 contrib)
            minmax: Dict[tuple, list] = {}  # (kind, dtype) -> entries
            guards: List[dict] = []         # decimal int64 bound checks

            def count_col(w) -> int:
                c = count_of.get(id(w))
                if c is None:
                    c = len(count_ws)
                    count_ws.append(w)
                    count_of[id(w)] = c
                return c

            for i, (kind, si) in enumerate(evaluated):
                if i in fused_idx:
                    continue
                w = si.w
                if kind in ("count", "sum"):
                    rm = run_space(kind, si)
                    if rm is not None:
                        # run-space COUNT / SUM: sum of run lengths (and
                        # of value * length) over the surviving runs —
                        # O(runs), the row-space plate never expands
                        total, cnt = code_agg.run_space_sum_count(
                            si.rpl.values, si.rpl.ends, rm)
                        r = cnt if kind == "count" else total
                        slot_arrays[i] = torch.stack([r, torch.zeros_like(r)])
                        note["passes"] += 1
                        note["strategies"].add("rle_runs")
                        note["lanes"].add("rle_runs")
                        continue
                if kind == "count":
                    count_users.append((i, count_col(w)))
                elif kind == "count_distinct":
                    # exact and sort-based, as in the reference (no hash
                    # table): order the (group, value-bits) pairs by two
                    # stable sorts — torch has no lexsort — and count the
                    # boundaries where the group or the value changes
                    vb = _dj.key_bits(si.v)
                    gw = torch.where(w, gidx.long(), num_groups)
                    o1 = torch.sort(vb, stable=True).indices
                    o2 = torch.sort(gw[o1], stable=True).indices
                    order = o1[o2]
                    g_s = gw[order]
                    v_s = vb[order]
                    new = torch.ones_like(g_s, dtype=torch.bool)
                    new[1:] = (g_s[1:] != g_s[:-1]) | (v_s[1:] != v_s[:-1])
                    cd = torch.zeros(nseg, dtype=torch.int64, device=dev)
                    cd.index_add_(0, g_s, new.to(torch.int64))
                    slot_arrays[i] = cd
                    note["passes"] += 1
                elif kind == "sum":
                    acc_dt = _acc_dtype(si.sdt, si.vdtype)
                    if dict_space_ok(kind, si):
                        # dictionary-space SUM: count codes into the
                        # (group, batch, code) space and contract with
                        # the dictionary stack — the value plate is never
                        # gathered (ops/code_agg.py)
                        slot_arrays[i] = code_agg.dict_space_sum(
                            si.cpl.codes, si.cpl.dicts, gidx, w, nseg)
                        note["passes"] += 1
                        note["strategies"].add("dict_space")
                        note["lanes"].add("dict_space")
                        continue
                    v = si.v
                    if (not groups and v.dtype == torch.float32
                            and kbits & 1):
                        # global f32 sum through the Kahan kernel: one
                        # compensated-f32 pass (ops/kahan_reduce.py)
                        total = masked_kahan_sum(v, w)
                        slot_arrays[i] = torch.stack(
                            [total, torch.zeros_like(total)])
                        note["passes"] += 1
                        note["strategies"].add("kahan")
                        continue
                    acc = v.to(acc_dt)
                    if acc_dt == torch.int64:
                        if si.sdt is not None and si.sdt.name == "decimal":
                            # exact scaled-int decimal sum: a group total
                            # CAN exceed int64 — bound-check max|v| *
                            # count (scaled by the tile count, so a tile
                            # pass bounds the MERGED total) and reroute
                            # to the host path instead of wrapping.  The
                            # absmax rides the minmax family with the
                            # int64-min filler: an all-masked group has
                            # count 0, so filler * 0 never trips it
                            tag = ("guard", len(guards))
                            minmax.setdefault(("max", torch.int64), []) \
                                .append((tag, torch.where(
                                    w, acc.abs(),
                                    reduction.extreme_value(torch.int64,
                                                            False))))
                            guards.append({"absmax": tag,
                                           "cnt": count_col(w)})
                        isum_cols.append(
                            (i, torch.where(w, acc, torch.zeros_like(acc))))
                    elif fsum_strat == "matmul" and w is valid and si.raw:
                        # bare non-null column: an invalid row's one-hot
                        # row is all-zero and its plate value is finite,
                        # so the select pass is pure overhead (packed_sum's
                        # finite check still covers NaN data)
                        fsum_cols.append((i, acc))
                    else:
                        fsum_cols.append(
                            (i, torch.where(w, acc, torch.zeros_like(acc))))
                elif kind == "sumsq":
                    acc = si.v.to(torch.float64)
                    fsum_cols.append((i, torch.where(
                        w, acc * acc, torch.zeros_like(acc))))
                elif kind in ("min", "max"):
                    v = si.v
                    fill = reduction.extreme_value(v.dtype, kind == "min")
                    minmax.setdefault((kind, v.dtype), []).append(
                        (("slot", i), torch.where(w, v, fill)))
                else:
                    raise CompileError(kind)

            if not fused:
                # the gvalid count joins the count family (and dedups
                # with any count slot over the plain validity mask)
                gvalid_col = count_col(valid)

            # --- family dispatch: one fused reduction each ---
            count_res = None
            join_counts = bool(count_ws) and fsum_strat == "matmul"
            if fsum_cols or join_counts:
                cols = [c for _, c in fsum_cols]
                if join_counts:
                    # counts ride the f64 matmul pack as 0/1 columns —
                    # exact below 2**53 rows, and an invalid row's
                    # one-hot row is all-zero, so the plain-validity count
                    # is a ones column
                    for w in count_ws:
                        cols.append(
                            torch.ones(n, dtype=torch.float64, device=dev)
                            if w is valid else w.to(torch.float64))
                oh = None
                if fsum_strat == "matmul":
                    # over the REAL groups only: an invalid row's one-hot
                    # row is all-zero and contributes nothing
                    oh = onehot if onehot is not None else \
                        reduction.make_onehot(gidx, num_groups,
                                              torch.float64)
                    if pre is not None and onehot is None:
                        _pre_cache_attach(pre, oh)
                res = reduction.packed_sum(cols, gidx, num_groups,
                                           fsum_strat, onehot=oh)
                note["passes"] += 1
                note["strategies"].add(fsum_strat)
                for pos, (i, _) in enumerate(fsum_cols):
                    slot_arrays[i] = res[:, pos]
                if join_counts:
                    count_res = torch.round(
                        res[:, len(fsum_cols):]).to(torch.int64)
            if count_ws and count_res is None:
                cdt = reduction.count_pack_dtype(n)
                count_res = reduction.packed_sum(
                    [w.to(cdt) for w in count_ws], gidx, num_groups,
                    fsum_strat).to(torch.int64)
                note["passes"] += 1
                note["strategies"].add(fsum_strat)
            for i, c in count_users:
                slot_arrays[i] = count_res[:, c]
            if isum_cols:
                istrat = reduction.resolve_strategy(
                    req, backend, num_groups, n, "isum", torch.int64)
                ires = reduction.packed_sum(
                    [c for _, c in isum_cols], gidx, num_groups, istrat)
                note["passes"] += 1
                note["strategies"].add(istrat)
                for pos, (i, _) in enumerate(isum_cols):
                    slot_arrays[i] = ires[:, pos]
            guard_res: Dict[tuple, torch.Tensor] = {}
            for (mkind, mdt), entries in minmax.items():
                mstrat = reduction.resolve_strategy(
                    req, backend, num_groups, n, "minmax", mdt)
                mres = reduction.packed_minmax(
                    mkind, [c for _, c in entries], gidx, num_groups, mstrat)
                note["passes"] += 1
                note["strategies"].add(mstrat)
                for pos, (tag, _) in enumerate(entries):
                    if tag[0] == "slot":
                        slot_arrays[tag[1]] = mres[:, pos]
                    else:
                        guard_res[tag] = mres[:, pos]
            for g in guards:
                absmax = guard_res[g["absmax"]]
                cnt_w = count_res[:, g["cnt"]]
                tscale = ctx.aux[tile_scale_aux].to(torch.float64)
                ctx.note_overflow(torch.any(
                    absmax.to(torch.float64) * cnt_w.to(torch.float64)
                    * tscale >= 2.0 ** 62))

            if fused:
                # the gvalid count rides the same streaming pass (its
                # shared-memory share is reserved in gk_bytes above)
                ops = [(k, v, w) for _, k, v, w in fused]
                ops.append(("count", None, valid))
                gk_out = grouped_reduce(ops, gidx, nseg)
                for (i, _, _, _), r in zip(fused, gk_out[:-1]):
                    slot_arrays[i] = r
                counts = gk_out[-1]
                note["passes"] += 1
                note["strategies"].add("grouped")
            else:
                counts = count_res[:, gvalid_col]
            if groups:
                gvalid = counts[:num_groups] > 0
            else:
                # SQL global aggregate always yields one row, even on
                # empty input
                gvalid = torch.ones(1, dtype=torch.bool, device=dev)

            # --- group key values per segment: decode the mixed-radix
            # group index back to key codes (+ per-key NULL masks), or,
            # on the generic lane, take each group's key value and NULL
            # flag by a segmented max over its rows ---
            post_cols: Dict[int, DVal] = {}
            if groups and not fast:
                for gi, kd in enumerate(kdvals):
                    kv = _broadcast_to_mask(kd.value, out.valid).reshape(-1)
                    knull = None
                    if kd.null is not None:
                        nb = _broadcast_to_mask(kd.null, out.valid) \
                            .reshape(-1)
                        knull = _segment_max(
                            (nb & valid).to(torch.int32), gidx,
                            num_groups).to(torch.bool)
                    post_cols[gi] = DVal(_segment_max(kv, gidx, num_groups),
                                         knull, post_scope_types[gi])
            elif groups:
                ar = torch.arange(num_groups, dtype=torch.int64, device=dev)
                strides = []
                acc = 1
                for ecard in reversed(eff_cards):
                    strides.append(acc)
                    acc *= ecard
                strides.reverse()
                for gi, (card, ecard, stride, kd, ki) in enumerate(zip(
                        cards, eff_cards, strides, kdvals, key_infos)):
                    kv = (ar // stride) % ecard
                    knull = None
                    if ecard > card:  # nullable key: code == card -> NULL
                        knull = kv == card
                        kv = torch.clamp(kv, max=card - 1)
                    if ki[0] == "vdict":
                        # domain code -> key value via the aux LUT
                        karr = ctx.aux[ki[2][1]][kv]
                    else:
                        karr = kv
                    karr = karr.to(T.torch_dtype(kd.dtype.device_dtype())) \
                        if kd.dtype is not None else karr
                    post_cols[gi] = DVal(karr, knull, post_scope_types[gi])

            # --- evaluate select expressions over [G] arrays ---
            for si, arr in enumerate(slot_arrays):
                post_cols[len(groups) + si] = DVal(
                    arr[:num_groups], None, slot_dtypes[si])
            post_rt = Runtime(post_cols, ctx.params, ctx.aux, dev)
            pairs = []
            for run in post_runs:
                dv = run(post_rt)
                pairs.append((dv.value, dv.null))
            notes[ctx.static] = {
                "passes": note["passes"],
                "strategies": frozenset(note["strategies"]),
                "lanes": frozenset(note["lanes"]),
                "rle_fallbacks": note["rle_fallbacks"],
                "table": base_table_ref}
            return gvalid, pairs

        self._agg_pre_emit = run_pre
        return run_agg, out_cols


class _PreEntry:
    """One group-index cache entry: phase A's outputs (ref
    snappydata_tpu/engine/executor.py `run_pre`)."""

    __slots__ = ("valid", "gidx", "num_groups", "overflow", "onehot")

    def __init__(self, valid, gidx, num_groups, overflow, onehot):
        self.valid = valid
        self.gidx = gidx
        self.num_groups = num_groups
        self.overflow = overflow
        self.onehot = onehot

    def nbytes(self) -> int:
        return sum(int(t.numel()) * t.element_size()
                   for t in (self.valid, self.gidx, self.overflow,
                             self.onehot)
                   if isinstance(t, torch.Tensor))


class _SlotInput:
    """One aggregate argument, evaluated once per execution.  Its row
    values `v` materialize lazily, so a slot that the dictionary-space or
    run-space lane takes never decodes its plate; `vdtype` is their dtype
    without decoding."""

    __slots__ = ("dv", "mask", "w", "sdt", "raw", "cpl", "rpl", "vdtype",
                 "_v")

    def __init__(self, dv: Optional[DVal], mask, w, raw: bool):
        self.dv = dv
        self.mask = mask           # the relation's [B, C] validity
        self.w = w                 # flat row weights: valid & not null
        self.raw = raw             # a bare stored column
        self.sdt = dv.dtype if dv is not None else None
        self.cpl = dv.cplate if raw and dv is not None else None
        self.rpl = dv.rplate if raw and dv is not None else None
        if dv is None:
            self.vdtype = None
        elif self.cpl is not None:
            self.vdtype = self.cpl.dicts.dtype
        elif self.rpl is not None:
            self.vdtype = self.rpl.values.dtype
        else:
            self.vdtype = dv.value.dtype
        self._v = None

    @property
    def v(self) -> Optional[torch.Tensor]:
        if self._v is None and self.dv is not None:
            self._v = _broadcast_to_mask(self.dv.value,
                                         self.mask).reshape(-1)
        return self._v


@dataclasses.dataclass
class _ScopeCol:
    name: str
    dtype: T.DataType
    dict_provider: Optional[Callable] = None
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class _SlotRef(ast.Expr):
    slot: int = 0
    dtype: T.DataType = None


@dataclasses.dataclass(frozen=True)
class _KeyRef(ast.Expr):
    key: int = 0
    dtype: T.DataType = None


def _slots_to_cols(e: ast.Expr, n_groups: int) -> ast.Expr:
    """Rewrite _SlotRef/_KeyRef into Col(index) for the post-agg scope."""
    if isinstance(e, _SlotRef):
        return ast.Col(f"__slot{e.slot}", None, n_groups + e.slot, e.dtype)
    if isinstance(e, _KeyRef):
        return ast.Col(f"__key{e.key}", None, e.key, e.dtype)
    return e.map_children(lambda c: _slots_to_cols(c, n_groups))


class _RunCtx:
    """Per-execution inputs of the emitted closures: per relation the
    bound (plate, null) pairs wrapped as DVals, the aux tensors, the
    literal scalars, the static key and the device.  `overflow` gathers
    the data-dependent overflow flags of nested nodes (a join expansion
    past its bucket, generic group keys past max_groups); the executor
    reads it once and reroutes to the exact host path."""

    def __init__(self, relations, rels, aux, params, static, device):
        self.aux = aux
        self.params = params
        self.static = static
        self.device = device
        self.overflow = None
        # the group-index cache's two phases (CompiledPlan.run): a hit's
        # phase B skips the filters, a miss hands phase A's child output
        # to phase B
        self.skip_filters = False
        self.pre_state = None
        self.rels = []
        for r, (cols, valid) in zip(relations, rels):
            dvals = {}
            cap = valid.shape[1]
            for ci, (col, null) in cols.items():
                f = r.info.schema.fields[ci]
                prov = _dict_provider(r.info, ci)
                # compressed-domain columns decode lazily, only where an
                # expression reads their values; comparisons take the
                # code / run lanes
                if isinstance(col, CodePlate):
                    dvals[ci] = DVal(None, null, f.dtype, prov, cplate=col)
                elif isinstance(col, RlePlate):
                    dvals[ci] = DVal(
                        None, null, f.dtype, prov, rplate=col, cap=cap,
                        decode=lambda p=col, c=cap: rle_values(p, c))
                elif isinstance(col, BitPlate):
                    dvals[ci] = DVal(
                        None, null, f.dtype, prov,
                        decode=lambda p=col, c=cap: bit_values(p, c))
                else:
                    dvals[ci] = DVal(col, null, f.dtype, prov)
            self.rels.append((dvals, valid))

    def runtime(self, cols: Dict[int, DVal]) -> Runtime:
        return Runtime(cols, self.params, self.aux, self.device)

    def note_overflow(self, flag) -> None:
        """OR a bool tensor (or a host bool) into the overflow flag."""
        flag = torch.as_tensor(flag, device=self.device)
        self.overflow = flag if self.overflow is None \
            else (self.overflow | flag)


def _dict_provider(info, ci):
    f = info.schema.fields[ci]
    col_store = not isinstance(info.data, RowTableData)
    if col_store and isinstance(f.dtype, T.ArrayType) \
            and f.dtype.element.name == "string":
        # ARRAY<STRING> plates carry element CODES: the provider is the
        # element dictionary (element_at decodes through it; contains
        # literals resolve to codes against it)
        return lambda: info.data.array_element_dictionary(ci)
    if col_store and isinstance(f.dtype, T.MapType) \
            and map_device_eligible(f.dtype):
        return MapDicts(
            lambda: info.data.map_key_dictionary(ci),
            (lambda: info.data.map_value_dictionary(ci))
            if f.dtype.value.name == "string" else None)
    if col_store and isinstance(f.dtype, T.StructType) \
            and struct_device_eligible(f.dtype):
        return StructDicts({
            fn: (lambda fn=fn: info.data.struct_field_dictionary(ci, fn))
            for fn, ft in f.dtype.fields if ft.name == "string"})
    if f.dtype.name != "string":
        return None
    if isinstance(info.data, RowTableData):
        return lambda: info.data.string_dict(ci)
    return lambda: info.data.dictionary(ci)


def _rle_agg_ready(data) -> int:
    """Static gate of the run-space aggregate lane: run arithmetic sums
    WHOLE runs, so a delete mask (row-level holes the runs cannot see)
    disqualifies the snapshot.  Deltas and row-buffer rows already
    disqualify the compressed bind itself."""
    if isinstance(data, RowTableData):
        return 0
    man = mvcc.snapshot_of(data)
    return int(not any(v.delete_mask is not None for v in man.views))


def _row_table_device(info, used, device: torch.device) -> DeviceTable:
    """A row table presents the same stacked [1, N] plate interface as a
    column table.  The DeviceTable is cached per (mutation version,
    device, columns); a pinned statement binds its captured host snapshot
    and keys the cache by the CAPTURED version."""
    data = info.data
    cache = data.__dict__.setdefault("_device_cache", {})
    pin = mvcc.current_pin()
    if pin is not None:
        arrays, row_masks, n, ver = pin.row_snapshot(data)
    else:
        arrays = None
        ver = data.version
    key = (ver, str(device), tuple(used))
    hit = cache.get(key)
    if hit is not None:
        return hit
    if arrays is None:
        arrays, row_masks, n = data.to_arrays_with_nulls()
    cap = max(1, n)
    cols, dicts, nulls = {}, {}, {}
    for ci in used:
        f = info.schema.fields[ci]
        if f.dtype.name == "string":
            d = data.string_dict(ci)
            dicts[ci] = d
            lookup = {v: i for i, v in enumerate(d.tolist())}
            vals = np.fromiter(
                (lookup.get(v if v is not None else "", 0)
                 for v in arrays[ci]), dtype=np.int32, count=n)
        elif f.dtype.name == "decimal" \
                and f.dtype.device_dtype().kind == "i":
            # exact decimal: host rows -> scaled int64 device plate
            vals = T.decimal_to_unscaled(
                f.dtype, np.asarray(arrays[ci], dtype=np.float64))
        else:
            vals = np.asarray(arrays[ci]).astype(f.dtype.device_dtype())
        padded = np.zeros(cap, dtype=vals.dtype)
        padded[:n] = vals
        cols[ci] = _upload(padded[None, :], device)
        nulls[ci] = None
        if row_masks[ci] is not None:
            nmask = np.zeros((1, cap), dtype=np.bool_)
            nmask[0, :n] = row_masks[ci]
            nulls[ci] = _upload(nmask, device)
    valid = np.zeros((1, cap), dtype=np.bool_)
    valid[0, :n] = True
    dt = DeviceTable(info.schema, 1, cap, _upload(valid, device), cols, dicts,
                     {}, {}, n, nulls)
    # old versions go, unless pinned or the LIVE version (a pinned bind
    # at an older capture must not evict the entry unpinned traffic hits)
    from snappydata_tpu_torch.storage.device import (_cache_budget,
                                                     _entry_bytes)

    pinned = mvcc.pinned_row_versions(data)
    live = data.version
    for k in [k for k in list(cache)
              if k[0] != ver and k[0] != live and k[0] not in pinned]:
        cache.pop(k, None)
        _cache_budget.forget(cache, k)
    cache[key] = dt
    if _cache_budget.enabled():
        _cache_budget.touch(cache, key, _entry_bytes(dt))
    return dt


def _derived_dict_provider(e: ast.Expr, scope):
    base = e
    while isinstance(base, ast.Alias):
        base = base.child
    if isinstance(base, ast.Col) and base.dtype is not None \
            and base.dtype.name == "string":
        return scope[base.index].dict_provider
    if isinstance(base, ast.Func) and base.name in STRING_VALUE_FUNCS:
        # derivable transforms (concat(s, '_x'), upper(s), ...) share the
        # base column's codes with a value-mapped dictionary
        builder = ExprBuilder({i: s.dtype for i, s in enumerate(scope)},
                              {}, {})
        try:
            ci, fn = builder._string_value_transform(base)
        except CompileError:
            return None
        if ci is None or scope[ci].dict_provider is None:
            return None
        prov = scope[ci].dict_provider
        return lambda: np.array([fn(v) for v in prov()], dtype=object)
    return None


def _element_dict_provider(e: ast.Expr, scope):
    """Dictionary of a projected element_at over a device-plated complex
    column whose value is a string CODE: the array element dictionary, the
    map value dictionary or the struct field's dictionary.  Only
    projections decode through it; a GROUP BY over such a value has no
    dictionary and takes the host path, as in the reference."""
    base = e
    while isinstance(base, ast.Alias):
        base = base.child
    if not (isinstance(base, ast.Func) and base.name == "element_at"
            and len(base.args) == 2):
        return None
    col = base.args[0]
    while isinstance(col, ast.Alias):
        col = col.child
    if not isinstance(col, ast.Col) or col.index is None:
        return None
    dt, prov = scope[col.index].dtype, scope[col.index].dict_provider
    if isinstance(dt, T.ArrayType) and dt.element.name == "string":
        return prov
    if isinstance(dt, T.MapType) and isinstance(prov, MapDicts):
        return prov.value
    if isinstance(dt, T.StructType) and isinstance(prov, StructDicts) \
            and isinstance(base.args[1], ast.Lit):
        want = str(base.args[1].value).lower()
        for fn, ft in dt.fields:
            if fn.lower() == want and ft.name == "string":
                return prov.fields.get(fn)
    return None


def _unique_dict_or_host(provider):
    """Wrap a derived-dictionary provider: grouping relies on a code to
    value bijection, so duplicate derived values reroute to the host."""
    def wrapped():
        d = provider()
        vals = d.tolist()
        if len(set(vals)) != len(vals):
            raise CompileError(
                "derived group dictionary is not value-unique: host path")
        return d

    return wrapped


def _padded_size(n: int) -> int:
    return 1 << max(0, (max(1, n) - 1).bit_length())


def _segment_max(v: torch.Tensor, gidx: torch.Tensor,
                 num_groups: int) -> torch.Tensor:
    """Per-group max of `v` over the rows of each group ([num_groups];
    rows in the overflow segment num_groups are dropped)."""
    is_bool = v.dtype == torch.bool
    if is_bool:
        v = v.to(torch.int32)
    out = torch.full((num_groups + 1,),
                     reduction.extreme_value(v.dtype, False),
                     dtype=v.dtype, device=v.device)
    out.scatter_reduce_(0, gidx.long(), v, "amax", include_self=True)
    out = out[:num_groups]
    return out.to(torch.bool) if is_bool else out


def merge_tile_outs(a, b, tags):
    """Elementwise on-device merge of two raw (mask, pairs, overflow)
    partial outputs over one ALIGNED group-index space (partial-raw
    compiles force data-independent cards, so slot i of tile A and tile
    B describe the same group).  Keys decode from the group index —
    identical across tiles — so either side's tensor serves; sum slots
    add (0 identity), min/max fold through their +/-inf fillers; the
    masks and overflow flags OR."""
    pairs = []
    for (va, na), (vb, _nb), tag in zip(a[1], b[1], tags):
        if tag[0] == "key":
            pairs.append((va, na))
        elif tag[1] == "min":
            pairs.append((torch.minimum(va, vb), None))
        elif tag[1] == "max":
            pairs.append((torch.maximum(va, vb), None))
        else:  # sum (covers counts and sumsq)
            pairs.append((va + vb, None))
    ov = a[2] if b[2] is None else (b[2] if a[2] is None else a[2] | b[2])
    return a[0] | b[0], pairs, ov


def _acc_dtype(dt: Optional[T.DataType], value_dtype) -> torch.dtype:
    """Aggregate accumulator dtype: float64 for floating outputs — the
    plates stay float32 on the card but the reductions widen (summing
    ~1e8 values of 1e4 into 1e10 totals in f32 leaves ~3 digits) — and
    int64 for integer sums.  DECIMAL with scaled-int64 plates (the exact
    path, p <= 18) accumulates in int64, EXACT; float-domain decimals
    (p > 18) keep the f64 accumulator."""
    if dt is not None and dt.name == "decimal":
        if not value_dtype.is_floating_point:
            return torch.int64
        return torch.float64
    if dt is not None and dt.name in ("float", "double"):
        return torch.float64
    if value_dtype.is_floating_point:
        return torch.float64
    return torch.int64


def _broadcast_to_mask(v, mask):
    if v.shape == mask.shape:
        return v
    return torch.broadcast_to(v, mask.shape)


def _segscan(op, vals: torch.Tensor, new_seg: torch.Tensor,
             span: int) -> torch.Tensor:
    """Inclusive segmented scan of `vals` under `op`, reset where
    `new_seg` is set: a doubling (Hillis-Steele) scan over the monoid
    (f, v) . (g, w) = (f | g, w if g else op(v, w)).  `span` is the
    longest segment, so ceil(log2(span)) passes suffice — no prefix
    crosses a segment start, and no value cancels against another
    segment's."""
    v = vals
    f = new_seg
    k = 1
    while k < span:
        v = torch.cat([v[:k], torch.where(f[k:], v[k:], op(v[:-k], v[k:]))])
        f = torch.cat([f[:k], f[k:] | f[:-k]])
        k *= 2
    return v


def _combine_keys(dvals: List[DVal]) -> torch.Tensor:
    """Combine N key DVals into one int64 key.  Single key: exact (NULL
    maps to a reserved sentinel).  Multiple: a 64-bit hash with the null
    flag folded in exactly (collision risk ~ n^2 * 2^-64).  NULL keys
    hash to their own group per SQL GROUP BY semantics.  One
    implementation, in ops/join.py: the cached build artifact and the
    bind-time expansion bound encode keys outside the plan, and the
    group and join key domains must never drift."""
    return _dj.combine_key_arrays([(d.value, d.null) for d in dvals])


# --- join helpers ---------------------------------------------------------

def _join_reject(reason: str, msg: str) -> None:
    """Reasoned device-join fallback: count the rejection (total + per
    reason, so operators can see WHY joins leave the device) and reroute
    to the exact host join via CompileError."""
    reg = global_registry()
    reg.inc("join_host_fallbacks")
    reg.inc("join_fallback_" + reason)
    raise CompileError(msg)


def _check_device_join_enabled(props) -> None:
    """Per-execution master switch (a bind check, so flipping the knob
    needs no plan-cache flush)."""
    if not props.get("device_join", True) \
            or not config.global_properties().get("device_join", True):
        _join_reject("disabled", "device_join=off: host path")


def _count_device_join() -> None:
    global_registry().inc("join_device_joins")


_expand_cap_warned: set = set()


def _warn_expand_cap(est: int, cap: int) -> None:
    """The expansion-cap fallback is loud: a query silently dropping to
    the single-threaded host join reads as a hang.  Once per (estimate
    bucket, cap)."""
    key = (est.bit_length(), cap)
    if key in _expand_cap_warned:
        return
    _expand_cap_warned.add(key)
    print(f"warning: device join expansion (~{est:,} bytes) exceeds "
          f"join_expand_max_bytes ({cap:,}) — query runs on the HOST "
          f"join path (single-threaded); raise the knob to keep it on "
          f"device", file=sys.stderr)


_absmax_cache: Dict[Tuple[int, int, int], tuple] = {}


def _require_f64_exact_int_key(info, ordinal: int) -> None:
    """Mixed int/float equi keys compare in the float64 domain; an int64
    key with |v| >= 2^53 would falsely match/miss after the cast.
    Verified per bind (cached per mutation version) — values at risk
    reroute to the exact host join."""
    data = info.data
    if isinstance(data, RowTableData):
        # the pin's captured version when pinned, else the live one
        pin = mvcc.current_pin()
        ver = pin.row_snapshot(data)[3] if pin is not None \
            else data.version
    else:
        ver = mvcc.snapshot_of(data).version
    key = (id(data), ver, ordinal)
    ok = None
    entry = _absmax_cache.get(key)
    if entry is not None:
        ref, cached_ok = entry
        if ref() is data:
            ok = cached_ok
    if ok is None:
        col = _host_key_columns(info, (ordinal,))[0]
        if col.size == 0:
            ok = True
        else:
            vals = np.abs(np.asarray(
                [0 if v is None else v for v in col], dtype=np.int64)) \
                if col.dtype == object else np.abs(col.astype(np.int64))
            ok = int(vals.max()) < (1 << 53)
        if len(_absmax_cache) > 4096:
            _absmax_cache.clear()
        _absmax_cache[key] = (weakref.ref(data), ok)
    if not ok:
        _join_reject(
            "int_float_key_2p53",
            f"join key {info.name}.{info.schema.fields[ordinal].name} "
            f"holds int values at |v| >= 2^53 — the float64 key domain "
            f"would be inexact; host path")


def _host_key_columns(info, ordinals: Tuple[int, ...]) -> List[np.ndarray]:
    """Host values of a table's key columns at the statement's snapshot:
    a row table's captured rows, or a column table's decoded live batch
    rows, then its row buffer."""
    data = info.data
    if isinstance(data, RowTableData):
        arrays, _, n, _ver = mvcc.row_snapshot_of(data)
        return [np.asarray(arrays[i])[:n] for i in ordinals]
    m = mvcc.snapshot_of(data)
    out = []
    for i in ordinals:
        name = info.schema.fields[i].name
        parts = []
        for view in m.views:
            live = view.live_mask()
            parts.append(np.asarray(data._decode_all(view)[name])[live])
        if m.row_count:
            parts.append(np.asarray(m.row_arrays[i])[:m.row_count])
        out.append(np.concatenate(parts) if parts
                   else np.empty(0, dtype=object))
    return out


def _collect_sargs(cond: ast.Expr, rel: _RelationInput) -> None:
    """Extract `numeric_col OP literal` conjuncts for stats skipping."""
    conjuncts: List[ast.Expr] = []

    def flatten(e):
        if isinstance(e, ast.BinOp) and e.op == "and":
            flatten(e.left)
            flatten(e.right)
        else:
            conjuncts.append(e)

    flatten(cond)
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    for c in conjuncts:
        if not (isinstance(c, ast.BinOp) and c.op in flip):
            continue
        col, lit, op = None, None, c.op
        if isinstance(c.left, ast.Col) and isinstance(
                c.right, (ast.Lit, ast.ParamLiteral, ast.Param)):
            col, lit = c.left, c.right
        elif isinstance(c.right, ast.Col) and isinstance(
                c.left, (ast.Lit, ast.ParamLiteral, ast.Param)):
            col, lit, op = c.right, c.left, flip[c.op]
        if col is None or col.dtype is None:
            continue
        if isinstance(lit, (ast.ParamLiteral, ast.Param)):
            get = (lambda params, p=lit.pos: params[p])
        else:
            get = (lambda params, v=lit.value: v)
        if col.dtype.name == "string":
            if op == "=":
                rel.str_sargs.append((col.index, get))
            continue
        if not T.is_numeric(col.dtype):
            continue
        rel.sargs.append((col.index, op, get))


def _expr_cols(e: Optional[ast.Expr]) -> set:
    if e is None:
        return set()
    return {x.index for x in ast.walk(e) if isinstance(x, ast.Col)}


def _plan_width(plan: ast.Plan) -> int:
    if isinstance(plan, ast.Relation):
        return len(plan.schema)
    if isinstance(plan, (ast.SubqueryAlias, ast.Filter)):
        return _plan_width(plan.child)
    if isinstance(plan, ast.Project):
        return len(plan.exprs)
    if isinstance(plan, ast.Aggregate):
        return len(plan.agg_exprs)
    if isinstance(plan, ast.Join):
        if plan.how in ("semi", "anti"):
            return _plan_width(plan.left)
        return _plan_width(plan.left) + _plan_width(plan.right)
    if isinstance(plan, ast.WindowProject):
        return len(plan.exprs)
    raise CompileError(f"width of {type(plan).__name__}")


def _validate_array_usage(plan: ast.Plan) -> None:
    """Array-typed columns may appear on device ONLY as the first argument
    of size/element_at/array_contains (their plate layout is opaque to
    every other operator) — anything else reroutes to the host path."""
    def check_expr(e: ast.Expr, allowed: bool) -> None:
        if isinstance(e, ast.Col) \
                and isinstance(e.dtype, (T.ArrayType, T.MapType,
                                         T.StructType)) \
                and not allowed:
            raise CompileError(
                "array/map/struct column outside size/element_at/"
                "array_contains: host path")
        for i, c in enumerate(e.children()):
            ok = isinstance(e, ast.Func) and i == 0 and \
                e.name in ARRAY_DEVICE_FUNCS
            check_expr(c, ok)

    def walk(p: ast.Plan) -> None:
        if isinstance(p, ast.Filter):
            check_expr(p.condition, False)
        elif isinstance(p, (ast.Project, ast.WindowProject)):
            for e in p.exprs:
                check_expr(e, False)
        elif isinstance(p, ast.Aggregate):
            for e in list(p.group_exprs) + list(p.agg_exprs):
                check_expr(e, False)
        elif isinstance(p, ast.Join) and p.condition is not None:
            check_expr(p.condition, False)
        for k in p.children():
            walk(k)

    walk(plan)


def _collect_used(plan: ast.Plan, needed: Optional[set],
                  out: List[set]) -> None:
    """Top-down pruning: which output ordinals of each Relation leaf (in
    DFS order) are actually consumed."""
    if isinstance(plan, ast.Relation):
        out.append(set(range(len(plan.schema))) if needed is None
                   else set(needed))
        return
    if isinstance(plan, ast.SubqueryAlias):
        _collect_used(plan.child, needed, out)
        return
    if isinstance(plan, ast.Filter):
        need = set(range(_plan_width(plan.child))) if needed is None \
            else set(needed)
        need |= _expr_cols(plan.condition)
        _collect_used(plan.child, need, out)
        return
    if isinstance(plan, ast.Project):
        need = set()
        for e in plan.exprs:
            need |= _expr_cols(e)
        _collect_used(plan.child, need, out)
        return
    if isinstance(plan, ast.Aggregate):
        need = set()
        for e in list(plan.group_exprs) + list(plan.agg_exprs):
            need |= _expr_cols(e)
        _collect_used(plan.child, need, out)
        return
    if isinstance(plan, ast.Join):
        wl = _plan_width(plan.left)
        wr = _plan_width(plan.right)
        if needed is None:
            top = wl if plan.how in ("semi", "anti") else wl + wr
            needed = set(range(top))
        needed = set(needed) | _expr_cols(plan.condition)
        _collect_used(plan.left, {i for i in needed if i < wl}, out)
        _collect_used(plan.right, {i - wl for i in needed if i >= wl}, out)
        return
    if isinstance(plan, ast.WindowProject):
        need = set()
        for e in plan.exprs:
            need |= _expr_cols(e)  # walk() covers args, partition, order
        _collect_used(plan.child, need, out)
        return
    raise CompileError(f"{type(plan).__name__} is not ported to the device "
                       f"path")


def _split_equi(cond: Optional[ast.Expr], nleft: int):
    """Split a join condition into equi pairs (left_idx, right_idx) and a
    residual expression."""
    if cond is None:
        return [], None
    conjuncts = []

    def flatten(e):
        if isinstance(e, ast.BinOp) and e.op == "and":
            flatten(e.left)
            flatten(e.right)
        else:
            conjuncts.append(e)

    flatten(cond)
    equi, rest = [], []
    for c in conjuncts:
        if isinstance(c, ast.BinOp) and c.op == "=" \
                and isinstance(c.left, ast.Col) \
                and isinstance(c.right, ast.Col):
            li, ri = c.left.index, c.right.index
            if li < nleft <= ri:
                equi.append((li, ri))
                continue
            if ri < nleft <= li:
                equi.append((ri, li))
                continue
        rest.append(c)
    residual = None
    for c in rest:
        residual = c if residual is None else ast.BinOp("and", residual, c)
    return equi, residual


# ==========================================================================
# Executor: peel host ops, run the device region, post-process
# ==========================================================================

class Executor:
    def __init__(self, catalog, props, device: torch.device):
        self.catalog = catalog
        self.props = props
        self.device = device
        # LRU: hitting plan_cache_size evicts the coldest entry only
        self._plan_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._depth = 0
        # plan caches are the first rung the resource broker's ladder
        # evicts (a weak registration: executors die with their sessions)
        from snappydata_tpu_torch.resource import global_broker

        global_broker().register_executor(self)

    def clear_cache(self):
        """Drop compiled plans, the group-index cache and the join
        build-artifact cache (the degradation ladder's first rung; all
        rebuild on next use)."""
        self._plan_cache.clear()
        clear_gidx_cache()
        _dj.clear_join_caches()

    def _cache_get(self, key):
        hit = self._plan_cache.get(key)
        if hit is not None:  # a cached False (no lowering) counts as a hit
            self._plan_cache.move_to_end(key)
        return hit

    def _cache_put(self, key, value) -> None:
        while len(self._plan_cache) >= self.props.plan_cache_size:
            self._plan_cache.popitem(last=False)
            global_registry().inc("plan_cache_evictions")
        self._plan_cache[key] = value

    def _compile(self, node: ast.Plan, **kw) -> CompiledPlan:
        """Compile one device region, timed as `plan_compile`."""
        import time

        t0 = time.perf_counter()
        try:
            return Compiler(self.catalog, self.props, **kw).compile(node)
        finally:
            global_registry().record_time("plan_compile",
                                          time.perf_counter() - t0)

    def compiled_core(self, node: ast.Plan,
                      key_str: Optional[str] = None
                      ) -> Optional[CompiledPlan]:
        """The CompiledPlan of a device-region node through the plan
        cache, or None when the node has no device lowering (the caller
        keeps the engine path).  The serving registry holds a prepared
        handle's compiled plan through this, so fused dispatches go
        straight to it without re-walking the plan per execute."""
        key = (key_str if key_str is not None else _plan_key(node),
               self.catalog.generation)
        compiled = self._cache_get(key)
        if compiled is None:
            try:
                compiled = self._compile(node)
            except CompileError:
                return None
            self._cache_put(key, compiled)
        return compiled

    def compiled_partial(self, node: ast.Plan) -> Optional[CompiledPlan]:
        """Compile an analyzed, tokenized partial-aggregate plan in
        partial-raw mode for the tiled scan's on-device merge.  Plan-cache
        aware (negative results cached too); None when the device region
        cannot lower it — the caller keeps the host-merge path."""
        key = ("__partial_raw__", _plan_key(node), self.catalog.generation)
        hit = self._cache_get(key)
        if hit is None:
            try:
                hit = self._compile(node, partial_raw=True)
            except CompileError:
                hit = False
            self._cache_put(key, hit)
        return hit or None

    def try_device(self, node: ast.Plan, params: Tuple) -> Optional[Result]:
        """Run `node` as a device program of its own when it lowers, else
        None.  Nothing counts as a host fallback: the caller is a host
        lane that carries on with the node itself when this declines."""
        key = ("__host_lane__", _plan_key(node), self.catalog.generation)
        compiled = self._cache_get(key)
        if compiled is None:
            try:
                compiled = Compiler(self.catalog, self.props).compile(node)
            except CompileError:
                compiled = False
            self._cache_put(key, compiled)
        if not compiled:
            return None
        try:
            return compiled.execute(params, self.device)
        except CompileError:
            return None

    def execute(self, plan: ast.Plan, params: Tuple = (),
                plan_key: Optional[str] = None) -> Result:
        """Run a tokenized plan.  `plan_key` is the core's plan-cache key
        when the caller holds it (a prepared handle), which skips the
        plan-repr walk per execute."""
        check_current()  # cancellation point: every (sub)plan execution
        if self._depth:  # nested calls (unions, host fallback) count once
            return self._execute_with_host_ops(plan, params, plan_key)
        reg = global_registry()
        reg.inc("queries")
        self._depth += 1
        try:
            result = self._execute_with_host_ops(plan, params, plan_key)
        finally:
            self._depth -= 1
        reg.inc("rows_returned", result.num_rows)
        return result

    def _execute_with_host_ops(self, plan: ast.Plan, params: Tuple,
                               plan_key: Optional[str] = None) -> Result:
        host_ops, node = peel_host_ops(plan)
        # executeTake early stop (ref: CachedDataFrame.executeTake:766): a
        # bare LIMIT over a scan chain decodes batches one at a time on
        # the host and stops as soon as enough rows survive, never
        # binding or materializing the whole table
        if len(host_ops) == 1 and isinstance(host_ops[0], ast.Limit):
            taken = self._try_take(node, host_ops[0].n, params)
            if taken is not None:
                return taken
        result = self._execute_core(node, params, plan_key)
        for op in reversed(host_ops):
            result = self._apply_host_op(op, result, params)
        return result

    def _execute_core(self, node: ast.Plan, params: Tuple,
                      plan_key: Optional[str] = None) -> Result:
        if isinstance(node, ast.Values):
            return hosteval.eval_values(node, params)
        if isinstance(node, ast.Union):
            return hosteval.union(self.execute(node.left, params),
                                  self.execute(node.right, params))
        if isinstance(node, ast.SetOp):
            return hosteval.set_op(self.execute(node.left, params),
                                   self.execute(node.right, params), node.op)
        reg = global_registry()
        fast = self._try_point_lookup(node, params)
        if fast is not None:
            return fast
        key = (plan_key if plan_key is not None else _plan_key(node),
               self.catalog.generation)
        compiled = self._cache_get(key)
        if compiled is None:
            reg.inc("plan_cache_misses")
            try:
                compiled = self._compile(node)
            except CompileError:
                reg.inc("host_fallbacks")
                return self._host_fallback(node, params)
            self._cache_put(key, compiled)
        else:
            reg.inc("plan_cache_hits")
        try:
            return compiled.execute(params, self.device)
        except CompileError:
            reg.inc("host_fallbacks")
            return self._host_fallback(node, params)

    def _try_take(self, node: ast.Plan, n: int, params: Tuple
                  ) -> Optional[Result]:
        """LIMIT n over Project? / Filter? / Relation on a column table:
        decode one batch at a time on the host, keep the qualifying rows,
        stop at n (ref snappydata_tpu/engine/executor.py `_try_take`).
        None when the shape does not qualify."""
        proj = filt = None
        cur = node
        if isinstance(cur, ast.Project):
            proj, cur = cur, cur.child
        while isinstance(cur, ast.SubqueryAlias):
            cur = cur.child
        if isinstance(cur, ast.Filter):
            filt, cur = cur, cur.child
        while isinstance(cur, ast.SubqueryAlias):
            cur = cur.child
        if not isinstance(cur, ast.Relation) or n <= 0:
            return None
        info = self.catalog.lookup_table(cur.name)
        if info is None or isinstance(info.data, RowTableData):
            return None  # row tables answer from their key index / are small
        checked = (list(proj.exprs) if proj else []) + \
            ([filt.condition] if filt else [])
        for e in checked:
            for x in ast.walk(e):
                if isinstance(x, (ast.WindowFunc, ast.ScalarSubquery,
                                  ast.InSubquery, ast.ExistsSubquery)):
                    return None
                if isinstance(x, ast.Func) and x.name in ast.AGG_FUNCS:
                    return None
        data = info.data
        m = mvcc.snapshot_of(data)
        schema = info.schema
        if proj is not None:
            names = [_expr_name(e) for e in proj.exprs]
            dtypes = [expr_type(e) or T.STRING for e in proj.exprs]
        else:
            names = schema.names()
            dtypes = [f.dtype for f in schema.fields]
        out_cols: List[List[np.ndarray]] = [[] for _ in names]
        out_nulls: List[List[Optional[np.ndarray]]] = [[] for _ in names]
        have = 0
        decoded = 0

        def consume(cols, nulls, cnt) -> None:
            nonlocal have
            if cnt == 0:
                return
            if filt is not None:
                v, nl = hosteval.eval_expr(filt.condition, cols, nulls,
                                           params, cnt)
                keep = np.broadcast_to(v, (cnt,)).astype(bool)
                if nl is not None:
                    keep = keep & ~np.broadcast_to(nl, (cnt,))
                idx = np.flatnonzero(keep)
                if idx.size == 0:
                    return
                cols = [c[idx] for c in cols]
                nulls = [nm[idx] if nm is not None else None
                         for nm in nulls]
                cnt = idx.size
            take = min(cnt, n - have)
            if proj is not None:
                for j, e in enumerate(proj.exprs):
                    v, nl = hosteval.eval_expr(e, cols, nulls, params, cnt)
                    out_cols[j].append(np.broadcast_to(v, (cnt,))[:take])
                    out_nulls[j].append(
                        np.broadcast_to(nl, (cnt,))[:take]
                        if nl is not None else None)
            else:
                for j in range(len(names)):
                    out_cols[j].append(cols[j][:take])
                    out_nulls[j].append(nulls[j][:take]
                                        if nulls[j] is not None else None)
            have += take

        for view in m.views:
            if have >= n:
                break
            check_current()  # batch boundary = cancellation point
            decoded += 1
            live = view.live_mask()
            lazy = data._decode_all(view)
            cols = [np.asarray(lazy[f.name])[live] for f in schema.fields]
            nulls = []
            for i in range(len(schema.fields)):
                nm = view.null_mask(i)
                nulls.append(nm[live] if nm is not None else None)
            consume(cols, nulls, int(live.sum()))
        if have < n and m.row_count:
            cols = [np.asarray(a)[:m.row_count] for a in m.row_arrays]
            nulls = [nm[:m.row_count] if nm is not None else None
                     for nm in (m.row_nulls or [None] * len(cols))]
            consume(cols, nulls, m.row_count)
        reg = global_registry()
        if decoded < len(m.views):
            reg.inc("take_early_stops")
        reg.inc("take_batches_decoded", decoded)
        final_cols, final_nulls = [], []
        for j, dt in enumerate(dtypes):
            if out_cols[j]:
                vals = np.concatenate(out_cols[j])
            else:
                vals = np.empty(0, dtype=object if dt.name == "string"
                                else dt.np_dtype)
            parts = out_nulls[j]
            nm = None
            if any(p is not None for p in parts):
                nm = np.concatenate(
                    [p if p is not None else np.zeros(len(c), dtype=bool)
                     for p, c in zip(parts, out_cols[j])])
            final_cols.append(vals)
            final_nulls.append(nm)
        return Result(names, final_cols, final_nulls, dtypes)

    def _try_point_lookup(self, node: ast.Plan, params: Tuple
                          ) -> Optional[Result]:
        """Point queries on a row table (`col = literal` conjuncts over
        every key column or over an index's columns, plain column
        projections) answer straight from the primary-key index or a
        secondary index, never entering the device engine (ref:
        ExecutionEngineArbiter routing simple queries to the store's own
        engine, docs/architecture/cluster_architecture.md:31-33)."""
        proj = None
        n = node
        if isinstance(n, ast.Project):
            proj, n = n, n.child
        while isinstance(n, ast.SubqueryAlias):
            n = n.child
        if not isinstance(n, ast.Filter):
            return None
        inner = n.child
        while isinstance(inner, ast.SubqueryAlias):
            inner = inner.child
        if not isinstance(inner, ast.Relation):
            return None
        info = self.catalog.lookup_table(inner.name)
        if info is None or not isinstance(info.data, RowTableData):
            return None
        pairs: Dict[str, object] = {}

        def flatten(e) -> bool:
            if isinstance(e, ast.BinOp) and e.op == "and":
                return flatten(e.left) and flatten(e.right)
            if isinstance(e, ast.BinOp) and e.op == "=" \
                    and isinstance(e.left, ast.Col) \
                    and isinstance(e.right, (ast.Lit, ast.ParamLiteral,
                                             ast.Param)):
                v = e.right.value if isinstance(e.right, ast.Lit) \
                    else params[e.right.pos]
                name = e.left.name.lower()
                if name in pairs and pairs[name] != v:
                    return False  # contradictory k=1 AND k=2: engine path
                pairs[name] = v
                return True
            return False

        if not flatten(n.condition):
            return None
        if proj is not None and not all(
                isinstance(e.child if isinstance(e, ast.Alias) else e,
                           ast.Col) for e in proj.exprs):
            return None
        key_set = frozenset(pairs)
        if info.key_columns and key_set == frozenset(info.key_columns):
            got = info.data.get(tuple(pairs[k] for k in info.key_columns))
            rows = [got] if got is not None else []
        else:
            idx = info.data.index_for_columns(sorted(key_set))
            if idx is None:
                return None
            rows = info.data.index_lookup(
                idx, tuple(pairs[c] for c in info.data._indexes[idx]))
        global_registry().inc("point_lookups")
        schema = info.schema
        if proj is not None:
            idxs = [(e.child if isinstance(e, ast.Alias) else e).index
                    for e in proj.exprs]
            names = [_expr_name(e) for e in proj.exprs]
            dtypes = [schema.fields[i].dtype for i in idxs]
            rows = [tuple(r[i] for i in idxs) for r in rows]
        else:
            names = schema.names()
            dtypes = [f.dtype for f in schema.fields]
        cols, nulls = [], []
        for j, dt in enumerate(dtypes):
            vals = [r[j] for r in rows]
            nmask = np.array([v is None for v in vals]) if vals else None
            if dt.name == "string":
                cols.append(np.array(vals, dtype=object))
            else:
                cols.append(np.array([0 if v is None else v for v in vals],
                                     dtype=dt.np_dtype))
            nulls.append(nmask if nmask is not None and nmask.any()
                         else None)
        return Result(names, cols, nulls, dtypes)

    def _host_fallback(self, node: ast.Plan, params: Tuple) -> Result:
        """CodegenSparkFallback analogue (core/.../execution/
        CodegenSparkFallback.scala:33): a construct without a device
        lowering evaluates on the host via numpy."""
        if isinstance(node, ast.WindowProject):
            return hosteval.eval_window(node, params, self)
        return hosteval.eval_plan(node, params, self)

    def _apply_host_op(self, op, result: Result, params) -> Result:
        if isinstance(op, ast.Limit):
            return hosteval.limit(result, op.n)
        if isinstance(op, ast.Distinct):
            return hosteval.distinct(result)
        if isinstance(op, ast.Sort):
            return hosteval.sort(result, op.orders, params)
        if isinstance(op, ast.Filter):
            return hosteval.filter_result(result, op.condition, params)
        if isinstance(op, ast.Project):
            return hosteval.project_result(result, op.exprs, params)
        raise CompileError(f"unknown host op {type(op).__name__}")


def peel_host_ops(plan: ast.Plan) -> Tuple[List, ast.Plan]:
    """Split a plan into (host_ops outermost-first, device-region core)."""
    host_ops: List = []
    node = plan
    while True:
        if isinstance(node, (ast.Sort, ast.Limit, ast.Distinct)):
            host_ops.append(node)
            node = node.children()[0]
            continue
        if isinstance(node, (ast.Filter, ast.Project)) \
                and _is_result_level(node.child):
            host_ops.append(node)
            node = node.child
            continue
        break
    return host_ops, node


def _is_result_level(child: ast.Plan) -> bool:
    """True when `child` produces a (small) materialized result whose
    parent ops should run on host: anything above an Aggregate."""
    if isinstance(child, (ast.Aggregate, ast.WindowProject)):
        return True
    if isinstance(child, (ast.Sort, ast.Limit, ast.Distinct)):
        return True
    if isinstance(child, (ast.Filter, ast.Project, ast.SubqueryAlias)):
        return _is_result_level(child.children()[0])
    return False


def _plan_key(plan: ast.Plan) -> str:
    """Structural cache key: the tokenized plan repr is stable because
    literals are ParamLiteral positions, not values.  The walk is O(plan)
    per call: a prepared handle computes it once and passes it back in,
    and `plan_key_builds` counts the walks."""
    global_registry().inc("plan_key_builds")
    return repr(plan)
