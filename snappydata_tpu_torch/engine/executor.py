"""Plan compiler + executor.

Port of snappydata_tpu/engine/executor.py, cut to the analytic scan: one
resolved logical plan (Scan / Filter / Project, with an optional Aggregate
root) lowers to ONE Python callable over stacked column-batch tensors —
the whole-stage-codegen analogue (ref: ColumnTableScan.doProduce
core/.../columnar/ColumnTableScan.scala:186, SnappyHashAggregateExec):

  Relation  -> stacked [B, C] device plates (storage/device.py)
  Filter    -> valid &= predicate
  Project   -> expression re-map
  Aggregate -> dictionary / vdict fast-path group index, then the slot
               loop: the fused grouped kernel (ops/group_reduce.py), the
               Kahan kernel (ops/kahan_reduce.py), the dictionary-space
               SUM and the run-space SUM/COUNT (ops/code_agg.py) and the
               packed reduction families (ops/reduction.py)

Everything above the aggregate (ORDER BY / LIMIT / DISTINCT / outer
projects) runs on the host over the small reduced result.  Joins, window
functions, generic (hash) group keys, exact decimals and the functions the
port's expression lowering lacks raise CompileError, and the executor
answers those plans with the host evaluator (engine/hosteval.py), as the
reference does for constructs it cannot lower.

PyTorch runs eagerly, so "compiling" a plan builds the closures once; the
closures read their static inputs (knob tokens, padded dictionary sizes)
at every execution, so flipping a knob needs no plan-cache flush.
Compiled plans are cached on the tokenized plan (ref: SnappySession plan
cache :2560-2566, PlanCacheSize 3000).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.engine import hosteval
from snappydata_tpu_torch.engine.exprs import (CompileError, DVal,
                                               ExprBuilder, Runtime)
from snappydata_tpu_torch.engine.result import Result
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.ops import code_agg, reduction
from snappydata_tpu_torch.ops import group_reduce as _gr
from snappydata_tpu_torch.ops.group_reduce import grouped_reduce
from snappydata_tpu_torch.ops.kahan_reduce import masked_kahan_sum
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.analyzer import _expr_name, expr_type
from snappydata_tpu_torch.storage.device import (batch_bucket,
                                                 build_device_table,
                                                 numeric_key_domain)
from snappydata_tpu_torch.storage.device_decode import (BitPlate, CodePlate,
                                                        RlePlate, bit_values,
                                                        compressed_fallback,
                                                        rle_values)


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
    whose literal, absent from the table dictionary, matches no batch."""

    def __init__(self, info, used: List[int]):
        self.info = info
        self.used = used
        self.sargs: List[Tuple[int, str, Callable]] = []
        self.str_sargs: List[Tuple[int, Callable]] = []

    def bind(self, device: torch.device):
        return build_device_table(self.info.data, self.used, device)

    def keep_mask(self, dt, params) -> Optional[np.ndarray]:
        """bool [B] of batches that can contain matches; None = keep all."""
        if not self.sargs and not self.str_sargs:
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
                 agg_notes: Optional[Dict] = None):
        self.relations = relations
        self.aux_builders = aux_builders
        self.static_providers = static_providers
        self.emitter = emitter
        self.out_scope = out_scope  # dict_provider read at assemble time
        self.is_aggregate = is_aggregate
        # per static key: the reduction strategies + lanes the aggregate
        # took, surfaced as per-execution metrics
        self.agg_notes = agg_notes

    def _bind(self, params: Tuple, device: torch.device):
        reg = global_registry()
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
        aux = [torch.from_numpy(np.ascontiguousarray(b(params))).to(device)
               for b in self.aux_builders]
        static = tuple(p() for p in self.static_providers)
        pvals = tuple(_param_scalar(v, device) for v in params)
        return rels, aux, static, pvals

    def run(self, params: Tuple, device: torch.device):
        """Bind + run; returns (mask, [(value, null), ...]) still on the
        device."""
        rels, aux, static, pvals = self._bind(params, device)
        ctx = _RunCtx(self.relations, rels, aux, pvals, static, device)
        outs = self.emitter(ctx)
        self._count_agg_notes(static)
        return outs

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
            compressed_fallback("rle_agg", note["rle_fallbacks"])

    def execute(self, params: Tuple, device: torch.device) -> Result:
        mask, pairs = self.run(params, device)
        # one host transfer per output array, after the whole region ran
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


def _param_scalar(v, device: torch.device) -> torch.Tensor:
    """One tokenized literal as a 0-dim tensor on `device`."""
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int64, device=device)
    if isinstance(v, (float, np.floating)):
        dt = torch.float64 if config.use_float64() else torch.float32
        return torch.tensor(float(v), dtype=dt, device=device)
    # strings ride only through LUT aux builders; position still needs a slot
    return torch.zeros((), dtype=torch.int32, device=device)


# ==========================================================================
# Compiler
# ==========================================================================

class Compiler:
    """Compiles one device region (Relation/Filter/Project[/Aggregate
    root]) into a CompiledPlan."""

    def __init__(self, catalog, props):
        self.catalog = catalog
        self.props = props
        self.relations: List[_RelationInput] = []
        self.aux_builders: List[Callable] = []
        self.static_providers: List[Callable] = []
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
        self._add_static(_compressed_token)
        # column pruning: per-relation needed ordinals, DFS leaf order
        self._pruned: List[set] = []
        _collect_used(plan, None, self._pruned)
        self._prune_cursor = 0
        emitter, out_cols = self._emit_node(plan)
        out_scope = [oc if isinstance(oc, _ScopeCol)
                     else _ScopeCol(oc.name, oc.dtype, oc.dict_provider)
                     for oc in out_cols]
        return CompiledPlan(self.relations, self.aux_builders,
                            self.static_providers, emitter, out_scope,
                            is_agg, self._agg_notes)

    # -- node emitters -----------------------------------------------------

    def _emit_node(self, plan: ast.Plan):
        """(emitter(ctx) -> (mask, [(val, null)...]), out_cols) for the
        region root."""
        if isinstance(plan, ast.Aggregate):
            return self._emit_aggregate(plan)
        rel_emit, scope = self._emit_rel(plan)

        def run_root(ctx) -> tuple:
            out = rel_emit(ctx)
            pairs = [(_broadcast_to_mask(out.cols[i].value, out.valid),
                      out.cols[i].null) for i in range(len(scope))]
            return out.valid, pairs

        return run_root, scope

    def _emit_rel(self, plan: ast.Plan):
        """Relational body -> (emitter(ctx) -> RelOut, scope)."""
        if isinstance(plan, ast.Relation):
            info = self.catalog.lookup_table(plan.name)
            pruned = self._pruned[self._prune_cursor] \
                if self._prune_cursor < len(self._pruned) else None
            self._prune_cursor += 1
            used = sorted(pruned) if pruned is not None \
                else list(range(len(info.schema)))
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
                          _derived_dict_provider(e, scope), True)
                for e in plan.exprs]

            def run_project(ctx) -> RelOut:
                out = child(ctx)
                rt = ctx.runtime(out.cols)
                return RelOut({i: r(rt) for i, r in enumerate(runs)},
                              out.valid, runf=out.runf)

            return run_project, out_scope

        raise CompileError(
            f"node {type(plan).__name__} is not ported to the device path")

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
                if arg is not None and e.name != "count" \
                        and expr_type(arg).name == "string":
                    raise CompileError(
                        f"{e.name} over a string: host path")
                if e.name == "count":
                    return _SlotRef(slot_of("count", arg), T.LONG)
                if e.name == "sum":
                    return _SlotRef(slot_of("sum", arg), expr_type(e))
                if e.name in ("min", "max", "first", "last"):
                    kind = {"first": "min", "last": "max"}.get(e.name, e.name)
                    return _SlotRef(slot_of(kind, arg), expr_type(arg))
                if e.name == "avg":
                    s = _SlotRef(slot_of("sum", arg), T.DOUBLE)
                    c = _SlotRef(slot_of("count", arg), T.LONG)
                    return ast.BinOp("/", s, c)
                if e.name in ("stddev", "variance"):
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
            if kind == "count":
                return T.LONG
            if kind == "sumsq":
                return T.DOUBLE
            return expr_type(arg) if arg is not None else T.DOUBLE

        slot_dtypes = [_slot_dtype(k, a) for k, a in slots]

        # key cardinalities (static): string keys use the padded dict size
        key_infos = []
        for g in groups:
            gt = expr_type(g)
            base_g = g.child if isinstance(g, ast.Alias) else g
            if gt.name == "string":
                provider = _derived_dict_provider(g, scope)
                if provider is None or not isinstance(base_g, ast.Col):
                    raise CompileError(
                        "string group key without a dictionary: host path")
                si = self._add_static(
                    lambda p=provider: _padded_size(len(p())))
                key_infos.append(("dict", si, provider))
            elif gt.name == "boolean":
                key_infos.append(("bool", None, None))
            elif (base_info is not None and isinstance(base_g, ast.Col)
                  and base_g.index is not None and gt.name != "decimal"
                  and T.is_numeric(gt)):
                # vdict: a direct numeric key of a base column table
                # groups through its table-global sorted value domain
                data, ci, mg = base_info.data, base_g.index, \
                    props.max_groups
                vd = (lambda d=data, c=ci, m=mg:
                      numeric_key_domain(d, c, m))
                si = self._add_static(lambda p=vd, m=mg: _vdict_card(p(), m))
                aux_ix = len(self.aux_builders)
                self.aux_builders.append(lambda params, p=vd: _vdict_lut(p()))
                key_infos.append(("vdict", si, (vd, aux_ix)))
            else:
                raise CompileError(
                    "generic (hash) group keys are not ported: host path")

        max_groups = props.max_groups
        strategy_si = self._add_static(lambda p=props: _strategy_token(p))
        code_agg_si = self._add_static(lambda p=props: _code_agg_token(p))
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

        def shape_info(ctx, kdvals):
            """(cards, eff_cards, num_groups) of the fast-path group
            space; raises CompileError past max_groups (the generic
            group-by is not ported)."""
            cards = []
            for (kind, si, _) in key_infos:
                cards.append(2 if kind == "bool" else ctx.static[si])
            # NULL group keys form their own group: a nullable key gets
            # one extra code slot = card
            eff_cards = [c + 1 if kd.null is not None else c
                         for c, kd in zip(cards, kdvals)]
            num_groups = int(np.prod(eff_cards))
            if num_groups > max_groups:
                raise CompileError(
                    f"{num_groups} groups exceed max_groups: host path")
            return cards, eff_cards, num_groups

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

        def run_agg(ctx) -> tuple:
            out = child(ctx)
            rt = ctx.runtime(out.cols)
            valid = out.valid.reshape(-1)
            n = valid.shape[0]
            dev = ctx.device
            kdvals = [kr(rt) for kr in key_runs]
            if groups:
                cards, eff_cards, num_groups = shape_info(ctx, kdvals)
            else:
                cards, eff_cards, num_groups = [], [], 1
            gidx = group_index(ctx, kdvals, out, valid, cards, eff_cards,
                               num_groups)
            nseg = num_groups + 1
            req = reduction.STRATEGIES[ctx.static[strategy_si]]
            fsum_strat = reduction.resolve_strategy(req, num_groups)
            note = {"passes": 0, "strategies": set(), "lanes": set(),
                    "rle_fallbacks": 0}
            tok = ctx.static[code_agg_si]
            # dictionary-space SUM is a scatter-heavy lane: auto keeps it
            # off the CPU; "on" forces it everywhere, "off" kills it.  The
            # run-space lane is cheap arithmetic: only "off" disables it.
            # (The reference also gates it on the snapshot holding no
            # delete mask; the port has no DELETE, so runs are whole.)
            code_agg_on = tok == 2 or (tok == 1 and dev.type != "cpu")
            rle_ok = tok != 0 and base_info is not None \
                and out.valid.dim() == 2
            if groups:
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
                    # expression over a plate is row-space math
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
            use_gk = bool(groups) and nseg <= _gr.MAX_GROUPS \
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
                        isum_cols.append(
                            (i, torch.where(w, acc, torch.zeros_like(acc))))
                    else:
                        fsum_cols.append(
                            (i, torch.where(w, acc, torch.zeros_like(acc))))
                elif kind == "sumsq":
                    acc = si.v.to(torch.float64)
                    fsum_cols.append((i, torch.where(
                        w, acc * acc, torch.zeros_like(acc))))
                elif kind in ("min", "max"):
                    v = si.v
                    fill = reduction.extreme_of(v.dtype, kind == "min", dev)
                    minmax.setdefault((kind, v.dtype), []).append(
                        (i, torch.where(w, v, fill)))
                else:
                    raise CompileError(kind)

            if not fused:
                # the gvalid count joins the count family (and dedups
                # with any count slot over the plain validity mask)
                gvalid_col = count_col(valid)

            # --- family dispatch: one fused reduction each ---
            if fsum_cols:
                res = reduction.packed_sum([c for _, c in fsum_cols], gidx,
                                           num_groups, fsum_strat)
                note["passes"] += 1
                note["strategies"].add(fsum_strat)
                for pos, (i, _) in enumerate(fsum_cols):
                    slot_arrays[i] = res[:, pos]
            count_res = None
            if count_ws:
                cdt = reduction.count_pack_dtype(n)
                count_res = reduction.packed_sum(
                    [w.to(cdt) for w in count_ws], gidx, num_groups,
                    fsum_strat).to(torch.int64)
                note["passes"] += 1
                note["strategies"].add(fsum_strat)
            for i, c in count_users:
                slot_arrays[i] = count_res[:, c]
            if isum_cols:
                istrat = reduction.resolve_strategy(req, num_groups)
                ires = reduction.packed_sum(
                    [c for _, c in isum_cols], gidx, num_groups, istrat)
                note["passes"] += 1
                note["strategies"].add(istrat)
                for pos, (i, _) in enumerate(isum_cols):
                    slot_arrays[i] = ires[:, pos]
            for (mkind, _dt), entries in minmax.items():
                mstrat = reduction.resolve_strategy(req, num_groups)
                mres = reduction.packed_minmax(
                    mkind, [c for _, c in entries], gidx, num_groups, mstrat)
                note["passes"] += 1
                note["strategies"].add(mstrat)
                for pos, (i, _) in enumerate(entries):
                    slot_arrays[i] = mres[:, pos]

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
            # group index back to key codes (+ per-key NULL masks) ---
            post_cols: Dict[int, DVal] = {}
            if groups:
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
                "rle_fallbacks": note["rle_fallbacks"]}
            return gvalid, pairs

        return run_agg, out_cols


class _SlotInput:
    """One aggregate argument, evaluated once per execution.  Its row
    values `v` materialize lazily, so a slot that the dictionary-space or
    run-space lane takes never decodes its plate; `vdtype` is their dtype
    without decoding."""

    __slots__ = ("dv", "mask", "w", "sdt", "cpl", "rpl", "vdtype", "_v")

    def __init__(self, dv: Optional[DVal], mask, w, raw: bool):
        self.dv = dv
        self.mask = mask           # the relation's [B, C] validity
        self.w = w                 # flat row weights: valid & not null
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
    literal scalars, the static key and the device."""

    def __init__(self, relations, rels, aux, params, static, device):
        self.aux = aux
        self.params = params
        self.static = static
        self.device = device
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


def _dict_provider(info, ci):
    if info.schema.fields[ci].dtype.name != "string":
        return None
    return lambda: info.data.dictionary(ci)


def _derived_dict_provider(e: ast.Expr, scope):
    base = e
    while isinstance(base, ast.Alias):
        base = base.child
    if isinstance(base, ast.Col) and base.dtype is not None \
            and base.dtype.name == "string":
        return scope[base.index].dict_provider
    return None


def _padded_size(n: int) -> int:
    return 1 << max(0, (max(1, n) - 1).bit_length())


def _acc_dtype(dt: Optional[T.DataType], value_dtype) -> torch.dtype:
    """Aggregate accumulator dtype: float64 for floating outputs — the
    plates stay float32 on the card but the reductions widen (summing
    ~1e8 values of 1e4 into 1e10 totals in f32 leaves ~3 digits) — and
    int64 for integer sums."""
    if dt is not None and dt.name in ("float", "double", "decimal"):
        return torch.float64
    if value_dtype.is_floating_point:
        return torch.float64
    return torch.int64


def _broadcast_to_mask(v, mask):
    if v.shape == mask.shape:
        return v
    return torch.broadcast_to(v, mask.shape)


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
    raise CompileError(f"width of {type(plan).__name__}")


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
    raise CompileError(f"{type(plan).__name__} is not ported to the device "
                       f"path")


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

    def clear_cache(self):
        self._plan_cache.clear()

    def _cache_get(self, key):
        hit = self._plan_cache.get(key)
        if hit is not None:
            self._plan_cache.move_to_end(key)
        return hit

    def _cache_put(self, key, value) -> None:
        while len(self._plan_cache) >= self.props.plan_cache_size:
            self._plan_cache.popitem(last=False)
            global_registry().inc("plan_cache_evictions")
        self._plan_cache[key] = value

    def execute(self, plan: ast.Plan, params: Tuple = ()) -> Result:
        if self._depth:  # nested calls (unions, host fallback) count once
            return self._execute_with_host_ops(plan, params)
        reg = global_registry()
        reg.inc("queries")
        self._depth += 1
        try:
            result = self._execute_with_host_ops(plan, params)
        finally:
            self._depth -= 1
        reg.inc("rows_returned", result.num_rows)
        return result

    def _execute_with_host_ops(self, plan: ast.Plan, params: Tuple
                               ) -> Result:
        host_ops, node = peel_host_ops(plan)
        result = self._execute_core(node, params)
        for op in reversed(host_ops):
            result = self._apply_host_op(op, result, params)
        return result

    def _execute_core(self, node: ast.Plan, params: Tuple) -> Result:
        if isinstance(node, ast.Values):
            return hosteval.eval_values(node, params)
        if isinstance(node, ast.Union):
            return hosteval.union(self.execute(node.left, params),
                                  self.execute(node.right, params))
        if isinstance(node, ast.SetOp):
            return hosteval.set_op(self.execute(node.left, params),
                                   self.execute(node.right, params), node.op)
        reg = global_registry()
        key = (_plan_key(node), self.catalog.generation)
        compiled = self._cache_get(key)
        if compiled is None:
            reg.inc("plan_cache_misses")
            try:
                compiled = Compiler(self.catalog, self.props).compile(node)
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
    literals are ParamLiteral positions, not values."""
    return repr(plan)
