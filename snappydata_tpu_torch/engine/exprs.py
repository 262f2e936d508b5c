"""Expression -> tensor lowering with three-valued (SQL NULL) logic.

Port of snappydata_tpu/engine/exprs.py, cut to the subset the analytic
scan and the join slice need (TPC-H Q1/Q3/Q5/Q6/Q10/Q12/Q14 and the
README Quick start): column refs, tokenized literals as runtime scalars,
+ - * / %, comparisons, BETWEEN, AND/OR/NOT with Kleene logic, IS NULL,
CASE WHEN, casts between numeric and decimal types, numeric IN lists,
string = / < / IN / LIKE through host-built dictionary lookup tables,
the code/run-domain compare lane (`_compressed_cmp`) and exact decimals
as scaled int64 values (`_dec_*`).  Anything else raises CompileError,
which the executor turns into the reference's host fallback
(engine/hosteval.py).

Design, as in the reference:
- Values are (value, null) pairs; null masks exist only where a source
  is nullable.
- Strings never reach the device: a string column is int32 dictionary
  codes, and a predicate `str_col OP literal` evaluates ONCE over the host
  dictionary into a bool lookup table applied as one gather.
- Tokenized literals arrive as 0-dim tensors, so a changed literal reuses
  the compiled plan.

Emission is two-phase: `ExprBuilder.emit` runs structurally (no tensors),
registering aux-input builders and returning a closure; the closure runs
at execution time over the bound plates.  PyTorch runs eagerly, so
"compiling" a plan only builds these closures.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.storage.device_decode import (code_cmp_mask,
                                                        code_values,
                                                        promote,
                                                        rle_expand_runs)


class CompileError(Exception):
    pass


class DVal:
    """A runtime value: device tensor + optional null mask + static type.

    A base-table column resident encoded decodes lazily, on the first read
    of `.value` (`decode`; a code plate's own gather when `cplate` is
    set), and comparisons against scalars take the code lane (`cplate`,
    a storage/device_decode.CodePlate) or the run lane (`rplate`, an
    RlePlate) instead of touching values.

    `rmask` / `rends` give a BOOLEAN value's run-space form: the per-run
    [B, R] mask whose expansion over the cumulative run ends `rends`
    equals `value` — identity on `rends` proves two masks talk about the
    same run partition.  Set only when `null` is None (a row-level null
    mask breaks run purity); the run-space aggregate lane consumes it."""

    __slots__ = ("_value", "null", "dtype", "dictionary", "cplate",
                 "rplate", "cap", "rmask", "rends", "_decode")

    def __init__(self, value, null=None, dtype: T.DataType = None,
                 dictionary=None, cplate=None, rplate=None, cap=None,
                 decode=None):
        self._value = value
        self.null = null
        self.dtype = dtype
        self.dictionary = dictionary
        self.cplate = cplate
        self.rplate = rplate
        self.cap = cap            # row capacity of a resident run plate
        self.rmask = None
        self.rends = None
        self._decode = decode

    @property
    def value(self) -> torch.Tensor:
        if self._value is None:
            if self._decode is not None:
                self._value = self._decode()
            elif self.cplate is not None:
                self._value = code_values(self.cplate)
        return self._value


def _or_null(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


_FLIP_CMP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
             "=": "=", "!=": "!="}

_CMP = {"=": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}

_ARITH = {"+": torch.add, "-": torch.sub, "*": torch.mul,
          "%": torch.remainder}


def _compressed_cmp(op: str, col: DVal, lit: DVal) -> Optional[DVal]:
    """Code/run-domain lowering of `col OP scalar-literal` when the column
    is resident as a code or run plate.  Value-domain equivalence is
    exact: code thresholds translate through the sorted dictionary in the
    promoted compare dtype, and run predicates compare the very values
    the expansion would yield.  None when the shape doesn't qualify — the
    generic value compare runs."""
    if col.cplate is None and col.rplate is None:
        return None
    if lit.cplate is not None or lit.rplate is not None:
        return None
    if lit.dtype is not None and lit.dtype.name == "string":
        return None
    # an EXACT decimal literal carries its SCALED int64 value: comparing
    # that against raw dictionary/run values would be off by 10^scale;
    # the generic lane unscales it
    if _dec_scale(lit) is not None:
        return None
    if lit.null is not None or lit.value.dim() != 0:
        return None
    if col.cplate is not None:
        m = code_cmp_mask(op, col.cplate, lit.value)
        return DVal(m, _or_null(col.null, lit.null), T.BOOLEAN)
    vals = col.rplate.values
    dt = promote(vals.dtype, lit.value.dtype)
    run_mask = _CMP[op](vals.to(dt), lit.value.to(dt))
    out = DVal(rle_expand_runs(run_mask, col.rplate.ends, col.cap),
               _or_null(col.null, lit.null), T.BOOLEAN)
    if out.null is None:
        # the expanded mask is PROVABLY the expansion of run_mask over
        # this run partition: carry the run form for the aggregate lane
        out.rmask = run_mask
        out.rends = col.rplate.ends
    return out


_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


def _is_exact_decimal(dt: Optional[T.DataType]) -> bool:
    return dt is not None and dt.name == "decimal" \
        and getattr(dt, "is_exact", False)


# ---------------------------------------------------------------------------
# Exact decimals: a DVal whose dtype is an exact DecimalType carries the
# SCALED int64 unscaled value (types.DecimalType docstring).  The binop /
# cast emitters keep +,-,*,%, comparisons and casts in the exact integer
# domain when the result precision fits int64, and unscale to float64
# otherwise.  Every other consumer (division, IN lists, CASE branches)
# receives the PLAIN float domain via _dec_unscale: scaled ints must
# never leak into value-blind float math.
# ---------------------------------------------------------------------------

def _dec_scale(d: DVal) -> Optional[int]:
    """Scale when d is an exact scaled-int decimal DVal, else None."""
    if _is_exact_decimal(d.dtype) and d.value.dtype in _INT_DTYPES:
        return d.dtype.scale
    return None


def _dec_unscale(d: DVal) -> DVal:
    """Exact decimal -> plain float64 DVal; anything else unchanged."""
    s = _dec_scale(d)
    if s is None:
        return d
    v = d.value.to(torch.float64) / (10 ** s)
    return DVal(v, d.null, T.DOUBLE, d.dictionary)


def _dec_wrap_unscaled(run: Callable[["Runtime"], DVal]
                       ) -> Callable[["Runtime"], DVal]:
    """Wrap an emitted closure so consumers see the float domain."""

    def wrapped(rt: "Runtime") -> DVal:
        return _dec_unscale(run(rt))

    return wrapped


def _dec_rescale_int(value: torch.Tensor, from_scale: int,
                     to_scale: int) -> torch.Tensor:
    """Scaled int64 -> scaled int64 at another scale, rounding half away
    from zero on downscale (Spark/java BigDecimal HALF_UP).  The floor
    division runs on |value|, so torch's flooring `//` never meets a
    negative operand."""
    if to_scale == from_scale:
        return value
    if to_scale > from_scale:
        return value * (10 ** (to_scale - from_scale))
    f = 10 ** (from_scale - to_scale)
    q = torch.div(value.abs() + f // 2, f, rounding_mode="floor")
    return torch.sign(value) * q


def _as_dec_operand(d: DVal):
    """(int64 values, DecimalType) for an operand that can join exact
    integer-domain math: an exact decimal, or an integer typed as
    decimal(digits, 0).  (None, None) for float operands."""
    s = _dec_scale(d)
    if s is not None:
        return d.value.to(torch.int64), d.dtype
    if d.value.dtype not in _INT_DTYPES:
        return None, None
    name = d.dtype.name if d.dtype is not None else "long"
    digits = T._INT_DIGITS.get(name)
    if digits is None:
        return None, None
    return d.value.to(torch.int64), T.DecimalType("decimal", digits, 0)


def _dec_cmp_float_scalar(op: str, d: DVal, s: int,
                          lit: torch.Tensor) -> DVal:
    """Compare an exact decimal against a float SCALAR (typically a
    tokenized literal) in the scaled-int domain: unscaling to float
    instead would mis-bucket boundary values (an f32 literal 24.05 is
    24.04999...).  Literals finer than the column scale (v <= 24.056 at
    scale 2 means v <= 24.05) take op-aware floor/ceil; literals too
    large for int64 take the float compare."""
    f = 10 ** s
    t = lit.to(torch.float64) * f
    r = torch.round(t)
    tol = 1e-6 * torch.clamp(t.abs(), min=1.0)
    is_int = (t - r).abs() <= tol
    safe = t.abs() <= 2.0 ** 62
    ts = torch.where(safe, t, torch.zeros_like(t))
    r64 = torch.round(ts).to(torch.int64)
    fl64 = torch.floor(ts).to(torch.int64)
    v = d.value.to(torch.int64)
    if op == "=":
        res_i = is_int & (v == r64)
    elif op == "!=":
        res_i = ~is_int | (v != r64)
    elif op == "<":
        res_i = v < torch.where(is_int, r64, fl64 + 1)
    elif op == "<=":
        res_i = v <= torch.where(is_int, r64, fl64)
    elif op == ">":
        res_i = v > torch.where(is_int, r64, fl64)
    else:  # >=
        res_i = v >= torch.where(is_int, r64, fl64 + 1)
    vf = v.to(torch.float64) / f
    res_f = _CMP[op](vf, lit.to(torch.float64))
    return DVal(torch.where(safe, res_i, res_f), d.null, T.BOOLEAN)


def _dec_binop(op: str, fn, a: DVal, b: DVal, is_cmp: bool
               ) -> Optional[DVal]:
    """Exact integer-domain lowering of a binop with >= 1 decimal side.
    None -> the caller unscales both sides and runs plain float math.
    Scale/precision rules shared with the analyzer via
    types.decimal_binop_type, so the declared output scale always equals
    the computed representation's."""
    av, adt = _as_dec_operand(a)
    bv, bdt = _as_dec_operand(b)
    if av is None or bv is None:
        if is_cmp:
            # decimal vs float SCALAR (tokenized literal): exact
            # scaled-int compare instead of a lossy float unscale
            sa, sb = _dec_scale(a), _dec_scale(b)
            if sa is not None and bv is None and b.value.dim() == 0:
                out = _dec_cmp_float_scalar(op, a, sa, b.value)
                return DVal(out.value, _or_null(a.null, b.null),
                            T.BOOLEAN)
            if sb is not None and av is None and a.value.dim() == 0:
                out = _dec_cmp_float_scalar(_FLIP_CMP[op], b, sb, a.value)
                return DVal(out.value, _or_null(a.null, b.null),
                            T.BOOLEAN)
        return None
    null = _or_null(a.null, b.null)
    if is_cmp:
        s = max(adt.scale, bdt.scale)
        if max(adt.precision + (s - adt.scale),
               bdt.precision + (s - bdt.scale)) \
                > T.DECIMAL_EXACT_MAX_PRECISION:
            return None  # alignment could overflow int64: f64 compare
        va = _dec_rescale_int(av, adt.scale, s)
        vb = _dec_rescale_int(bv, bdt.scale, s)
        return DVal(fn(va, vb), null, T.BOOLEAN)
    out_dt = T.decimal_binop_type(op, adt, bdt)
    if not isinstance(out_dt, T.DecimalType) or not out_dt.is_exact:
        return None
    if op == "*":
        # scales add under int multiply: already at out_dt.scale
        return DVal(av * bv, null, out_dt)
    va = _dec_rescale_int(av, adt.scale, out_dt.scale)
    vb = _dec_rescale_int(bv, bdt.scale, out_dt.scale)
    return DVal(fn(va, vb), null, out_dt)


def float_dtype() -> torch.dtype:
    return torch.float64 if config.use_float64() else torch.float32


class Runtime:
    """Runtime tensors handed to emitted closures."""

    def __init__(self, cols: Dict[int, DVal], params: Sequence,
                 aux: Sequence, device: torch.device):
        self.cols = cols
        self.params = params  # 0-dim tensors, one per tokenized literal
        self.aux = aux        # aux tensors, in registration order
        self.device = device


class ExprBuilder:
    """Structural compiler for one scope.

    col_types[i] — dtype of input ordinal i
    col_nullable[i] — whether ordinal i can produce nulls
    dict_getters[i] — bind-time callable returning the CURRENT host
        dictionary for string ordinal i (dictionaries grow with ingest)
    """

    def __init__(self, col_types: Dict[int, T.DataType],
                 col_nullable: Dict[int, bool],
                 dict_getters: Dict[int, Callable[[], np.ndarray]]):
        self.col_types = col_types
        self.col_nullable = col_nullable
        self.dict_getters = dict_getters
        # aux builders: fn(params: tuple) -> np.ndarray, run at bind time
        self.aux_builders: List[Callable] = []

    # -- aux registration --------------------------------------------------

    def _register_aux(self, builder: Callable) -> int:
        self.aux_builders.append(builder)
        return len(self.aux_builders) - 1

    def _string_pred_lut(self, col_idx: int,
                         fn: Callable[[np.ndarray, tuple], np.ndarray]) -> int:
        """Register a bool LUT over the column's dictionary, padded to a
        power of two so dictionary growth rarely changes its shape."""
        if col_idx not in self.dict_getters:
            raise CompileError("string column without a dictionary")
        getter = self.dict_getters[col_idx]

        def build(params):
            d = getter()
            lut = fn(d, params).astype(np.bool_)
            n = max(1, len(lut))
            padded = 1 << (n - 1).bit_length()
            if padded > len(lut):
                lut = np.concatenate([lut, np.zeros(padded - len(lut),
                                                    dtype=np.bool_)])
            return lut

        return self._register_aux(build)

    # -- literals ----------------------------------------------------------

    def _param_value(self, e, params):
        if isinstance(e, (ast.ParamLiteral, ast.Param)):
            return params[e.pos]
        if isinstance(e, ast.Lit):
            return e.value
        raise CompileError("expected literal")

    @staticmethod
    def _is_literalish(e) -> bool:
        return isinstance(e, (ast.Lit, ast.ParamLiteral, ast.Param))

    # -- main emit ---------------------------------------------------------

    def emit(self, e: ast.Expr) -> Callable[[Runtime], DVal]:
        if isinstance(e, ast.Alias):
            return self.emit(e.child)

        if isinstance(e, ast.Col):
            idx = e.index

            def run_col(rt: Runtime) -> DVal:
                return rt.cols[idx]

            return run_col

        if isinstance(e, ast.Lit):
            return self._emit_literal(e.value, e.dtype)

        if isinstance(e, (ast.ParamLiteral, ast.Param)):
            pos, dtype = e.pos, e.dtype
            if dtype is not None and dtype.name == "string":
                raise CompileError(
                    "string literal outside a dictionary predicate")

            def run_param(rt: Runtime) -> DVal:
                return DVal(rt.params[pos], None, dtype or T.DOUBLE)

            return run_param

        if isinstance(e, ast.BinOp):
            return self._emit_binop(e)

        if isinstance(e, ast.UnaryOp):
            child = self.emit(e.child)
            if e.op == "not":
                def run_not(rt: Runtime) -> DVal:
                    c = child(rt)
                    return DVal(~c.value, c.null, T.BOOLEAN)

                return run_not

            def run_neg(rt: Runtime) -> DVal:
                c = child(rt)
                return DVal(-c.value, c.null, c.dtype)

            return run_neg

        if isinstance(e, ast.IsNull):
            child = self.emit(e.child)
            negated = e.negated

            def run_isnull(rt: Runtime) -> DVal:
                c = child(rt)
                null = c.null if c.null is not None else torch.zeros(
                    c.value.shape, dtype=torch.bool, device=rt.device)
                return DVal(~null if negated else null, None, T.BOOLEAN)

            return run_isnull

        if isinstance(e, ast.Between):
            both = ast.BinOp("and", ast.BinOp(">=", e.child, e.lo),
                             ast.BinOp("<=", e.child, e.hi))
            if e.negated:
                both = ast.UnaryOp("not", both)
            return self.emit(both)

        if isinstance(e, ast.InList):
            return self._emit_in(e)

        if isinstance(e, ast.Cast):
            return self._emit_cast(e)

        if isinstance(e, ast.Like):
            return self._emit_like(e)

        if isinstance(e, ast.Case):
            return self._emit_case(e)

        if isinstance(e, ast.Func) and e.name in ast.AGG_FUNCS:
            raise CompileError(
                f"aggregate {e.name} outside aggregation context")

        if isinstance(e, ast.Func) and e.name == "sqrt" \
                and len(e.args) == 1:
            # the one scalar function lowered so far: stddev's finish step
            # (as the reference, in the plates' float width)
            child = _dec_wrap_unscaled(self.emit(e.args[0]))

            def run_sqrt(rt: Runtime) -> DVal:
                c = child(rt)
                return DVal(torch.sqrt(c.value.to(float_dtype())), c.null,
                            T.DOUBLE)

            return run_sqrt

        raise CompileError(f"{type(e).__name__} "
                           f"{getattr(e, 'name', '')} is not ported to the "
                           f"device path")

    # -- pieces ------------------------------------------------------------

    def _emit_literal(self, value, dtype) -> Callable[[Runtime], DVal]:
        if value is None:
            def run_null(rt: Runtime) -> DVal:
                z = torch.zeros((), dtype=torch.float32, device=rt.device)
                return DVal(z, torch.ones((), dtype=torch.bool,
                                          device=rt.device),
                            dtype or T.DOUBLE)

            return run_null
        if dtype is not None and dtype.name == "string":
            raise CompileError(
                "string literal outside a dictionary predicate")
        eff = dtype or (T.DOUBLE if isinstance(value, float) else T.LONG)
        if _is_exact_decimal(eff):
            # exact-decimal literal: store the SCALED unscaled value, as
            # the reference does (a plain int64 cast would truncate 24.05
            # to 24 and then decode as 0.24)
            import decimal as _d

            q = _d.Decimal(value if isinstance(value, (_d.Decimal, int))
                           else repr(float(value)))
            const = np.asarray(int(q.scaleb(eff.scale).to_integral_value(
                rounding=_d.ROUND_HALF_UP)), dtype=np.int64)
        else:
            const = np.asarray(value, dtype=eff.device_dtype())

        def run_lit(rt: Runtime) -> DVal:
            return DVal(torch.from_numpy(const).to(rt.device), None, eff)

        return run_lit

    def _string_operand_info(self, e: ast.Expr) -> Optional[int]:
        """If e is (an alias of) a raw string column, return its ordinal."""
        if isinstance(e, ast.Alias):
            return self._string_operand_info(e.child)
        if isinstance(e, ast.Col):
            dt = e.dtype if e.dtype is not None \
                else self.col_types.get(e.index)
            if dt is not None and dt.name == "string":
                return e.index
        return None

    def _emit_binop(self, e: ast.BinOp) -> Callable[[Runtime], DVal]:
        op = e.op
        # --- string predicate vs literal -> dictionary LUT ---
        if op in _CMP:
            lcol = self._string_operand_info(e.left)
            rcol = self._string_operand_info(e.right)
            if lcol is not None and self._is_literalish(e.right):
                return self._emit_string_cmp(lcol, op, e.right)
            if rcol is not None and self._is_literalish(e.left):
                return self._emit_string_cmp(rcol, _FLIP_CMP[op], e.left)
            if lcol is not None and rcol is not None:
                return self._emit_string_colcmp(lcol, rcol, op)
            if lcol is not None or rcol is not None:
                raise CompileError("string comparison shape: host path")

        left = self.emit(e.left)
        right = self.emit(e.right)

        if op in ("and", "or"):
            is_and = op == "and"

            def run_logic(rt: Runtime) -> DVal:
                a, b = left(rt), right(rt)
                v = (a.value & b.value) if is_and else (a.value | b.value)
                null = None
                if a.null is not None or b.null is not None:
                    an = a.null if a.null is not None else False
                    bn = b.null if b.null is not None else False
                    if is_and:  # Kleene: false and null = false
                        null = (an & bn) | (an & b.value) | (bn & a.value)
                        v = v & ~null
                    else:       # true or null = true
                        null = (an & bn) | (an & ~b.value) | (bn & ~a.value)
                out = DVal(v, null, T.BOOLEAN)
                # run-space conjunction: both sides run-resident over the
                # SAME run partition (identity on ends) combine in O(R)
                # run space, so the alignment proof survives the tree
                if (null is None and a.rmask is not None
                        and b.rmask is not None and a.rends is b.rends):
                    out.rmask = (a.rmask & b.rmask) if is_and \
                        else (a.rmask | b.rmask)
                    out.rends = a.rends
                return out

            return run_logic

        if op == "/":
            def run_div(rt: Runtime) -> DVal:
                # exact decimals leave the int domain here: decimal
                # division is DOUBLE in this engine, as in the reference
                a, b = _dec_unscale(left(rt)), _dec_unscale(right(rt))
                av, bv = a.value, b.value
                if not av.is_floating_point():
                    av = av.to(float_dtype())
                if not bv.is_floating_point():
                    bv = bv.to(float_dtype())
                dt = promote(av.dtype, bv.dtype)
                zero = b.value == 0
                null = _or_null(_or_null(a.null, b.null), zero)
                safe = torch.where(zero, torch.ones((), dtype=dt,
                                                    device=rt.device),
                                   bv.to(dt))
                return DVal(av.to(dt) / safe, null, T.DOUBLE)

            return run_div

        is_cmp = op in _CMP
        if not is_cmp and op not in _ARITH:
            raise CompileError(f"operator {op} is not ported")
        fn = _CMP[op] if is_cmp else _ARITH[op]

        def run_bin(rt: Runtime) -> DVal:
            a, b = left(rt), right(rt)
            if is_cmp:
                # compressed-domain lane: a code-resident column vs a
                # scalar literal compares on codes, never on values
                cm = _compressed_cmp(op, a, b)
                if cm is None:
                    cm = _compressed_cmp(_FLIP_CMP[op], b, a)
                if cm is not None:
                    return cm
            if _dec_scale(a) is not None or _dec_scale(b) is not None:
                out = _dec_binop(op, fn, a, b, is_cmp)
                if out is not None:
                    return out
                # the result leaves the exact domain (a float operand, or
                # the precision outgrew int64): plain float math
                a, b = _dec_unscale(a), _dec_unscale(b)
            av, bv = a.value, b.value
            dt = promote(av.dtype, bv.dtype)
            v = fn(av.to(dt), bv.to(dt))
            out_t = T.BOOLEAN if is_cmp else _promote(a.dtype, b.dtype)
            return DVal(v, _or_null(a.null, b.null), out_t)

        return run_bin

    def _emit_string_cmp(self, col_idx: int, op: str, lit_expr
                         ) -> Callable[[Runtime], DVal]:
        get_lit = (lambda params: self._param_value(lit_expr, params))
        ops = {"=": np.equal, "!=": np.not_equal,
               "<": np.less, "<=": np.less_equal,
               ">": np.greater, ">=": np.greater_equal}
        cmp = ops[op]

        def one(v, params):
            return v is not None and bool(cmp(v, get_lit(params)))

        aux_i = self._string_pred_lut(
            col_idx, lambda d, params: np.array(
                [one(v, params) for v in d],
                dtype=np.bool_) if len(d) else np.zeros(0, np.bool_))
        return self._lut_runner(col_idx, aux_i)

    def _emit_string_colcmp(self, li: int, ri: int, op: str
                            ) -> Callable[[Runtime], DVal]:
        """string col vs string col — same-dictionary equality only."""
        if op not in ("=", "!="):
            raise CompileError("ordering between two string columns "
                               "is not supported on device")
        neg = op == "!="

        def run(rt: Runtime) -> DVal:
            a, b = rt.cols[li], rt.cols[ri]
            da = a.dictionary() if callable(a.dictionary) else a.dictionary
            db = b.dictionary() if callable(b.dictionary) else b.dictionary
            if da is not None and db is not None and da is not db and \
                    list(da) != list(db):
                raise CompileError("cross-dictionary string comparison "
                                   "not supported on device")
            v = (a.value != b.value) if neg else (a.value == b.value)
            return DVal(v, _or_null(a.null, b.null), T.BOOLEAN)

        return run

    def _lut_runner(self, col_idx: int, aux_i: int
                    ) -> Callable[[Runtime], DVal]:
        def run(rt: Runtime) -> DVal:
            c = rt.cols[col_idx]
            lut = rt.aux[aux_i]
            codes = c.value
            v = torch.index_select(lut, 0, codes.reshape(-1)) \
                .reshape(codes.shape)
            return DVal(v, c.null, T.BOOLEAN)

        return run

    def _emit_in(self, e: ast.InList) -> Callable[[Runtime], DVal]:
        negated = e.negated
        col_idx = self._string_operand_info(e.child)
        if col_idx is not None:
            getters = [(lambda params, x=v: self._param_value(x, params))
                       for v in e.values]
            aux_i = self._string_pred_lut(
                col_idx,
                lambda d, params: np.isin(
                    np.array([x if x is not None else "" for x in d]),
                    np.array([str(g(params)) for g in getters])))
            base = self._lut_runner(col_idx, aux_i)
            if not negated:
                return base

            def run_negated(rt: Runtime) -> DVal:
                r = base(rt)
                return DVal(~r.value, r.null, T.BOOLEAN)

            return run_negated

        if len(e.values) > 8:
            raise CompileError("large IN list: host path")
        child = _dec_wrap_unscaled(self.emit(e.child))
        values = [_dec_wrap_unscaled(self.emit(v)) for v in e.values]

        def run_in(rt: Runtime) -> DVal:
            c = child(rt)
            acc = None
            null = c.null
            for v in values:
                dv = v(rt)
                dt = promote(c.value.dtype, dv.value.dtype)
                hit = c.value.to(dt) == dv.value.to(dt)
                null = _or_null(null, dv.null)
                acc = hit if acc is None else (acc | hit)
            if negated:
                acc = ~acc
            return DVal(acc, null, T.BOOLEAN)

        return run_in

    def _emit_like(self, e: ast.Like) -> Callable[[Runtime], DVal]:
        """`str_col [NOT] LIKE pattern`: one bool LUT over the column's
        dictionary, like every string predicate."""
        col_idx = self._string_operand_info(e.child)
        if col_idx is None:
            raise CompileError("LIKE requires a string column")
        # SQL LIKE: % = any run, _ = any single char
        regex = re.compile(
            "^" + re.escape(e.pattern).replace("%", ".*").replace("_", ".")
            + "$", re.DOTALL)
        negated = e.negated

        def one(v):
            return v is not None and regex.match(v) is not None

        aux_i = self._string_pred_lut(
            col_idx, lambda d, params: np.array([one(v) for v in d],
                                                dtype=np.bool_))
        base = self._lut_runner(col_idx, aux_i)
        if not negated:
            return base

        def run_neg(rt: Runtime) -> DVal:
            r = base(rt)
            return DVal(~r.value, r.null, T.BOOLEAN)

        return run_neg

    def _emit_case(self, e: ast.Case) -> Callable[[Runtime], DVal]:
        # branch values unscale exact decimals: branches mix with
        # literals and other types, and scaled ints must not meet plain
        # values in one torch.where lattice
        whens = [(self.emit(c), _dec_wrap_unscaled(self.emit(v)))
                 for c, v in e.whens]
        other = _dec_wrap_unscaled(self.emit(e.otherwise)) \
            if e.otherwise is not None else None

        def run_case(rt: Runtime) -> DVal:
            branches = [(c(rt), v(rt)) for c, v in whens]
            # the result type promotes across ALL branches (ELSE 0 must
            # not demote a double CASE to an integer one)
            dt = None
            for _, v_dv in branches:
                dt = _promote(dt, v_dv.dtype)
            if other is not None:
                out = other(rt)
                dt = _promote(dt, out.dtype)
                acc_v, acc_n = out.value, out.null
            else:
                acc_v = torch.zeros_like(branches[0][1].value)
                # no branch matched -> NULL
                acc_n = torch.ones((), dtype=torch.bool, device=rt.device)
            no = torch.zeros((), dtype=torch.bool, device=rt.device)
            for cond, val in reversed(branches):
                cv = cond.value
                if cond.null is not None:
                    cv = cv & ~cond.null
                vdt = promote(acc_v.dtype, val.value.dtype)
                acc_v = torch.where(cv, val.value.to(vdt), acc_v.to(vdt))
                if acc_n is None and val.null is None:
                    continue
                acc_n = torch.where(cv, no if val.null is None else val.null,
                                    no if acc_n is None else acc_n)
            return DVal(acc_v, acc_n, dt)

        return run_case

    def _emit_cast(self, e: ast.Cast) -> Callable[[Runtime], DVal]:
        to = e.to
        if to.name == "string" or not (
                T.is_numeric(to) or to.name == "boolean"):
            raise CompileError(f"CAST to {to} is not ported to the device "
                               f"path")
        child = self.emit(e.child)
        tdt = T.torch_dtype(to.device_dtype())
        to_exact = _is_exact_decimal(to)

        def run_cast(rt: Runtime) -> DVal:
            c = child(rt)
            s_from = _dec_scale(c)
            if s_from is not None:
                if to_exact:  # decimal -> decimal: integer rescale
                    return DVal(_dec_rescale_int(
                        c.value.to(torch.int64), s_from, to.scale),
                        c.null, to)
                if T.is_integral(to):
                    # decimal -> int truncates toward zero (Spark), in
                    # the int domain
                    iv = c.value.to(torch.int64)
                    tv = torch.sign(iv) * torch.div(
                        iv.abs(), 10 ** s_from, rounding_mode="floor")
                    return DVal(tv.to(tdt), c.null, to)
                c = _dec_unscale(c)
            if to_exact:
                v = c.value
                if v.dtype in _INT_DTYPES:
                    return DVal(v.to(torch.int64) * (10 ** to.scale),
                                c.null, to)
                # HALF_UP (half away from zero), matching
                # decimal_to_unscaled / _dec_rescale_int: torch.round
                # would tie to even
                vf = v.to(torch.float64) * (10 ** to.scale)
                scaled = torch.sign(vf) * torch.floor(vf.abs() + 0.5)
                return DVal(scaled.to(torch.int64), c.null, to)
            return DVal(c.value.to(tdt), c.null, to)

        return run_cast


def _promote(a: Optional[T.DataType], b: Optional[T.DataType]) -> T.DataType:
    if a is None:
        return b or T.DOUBLE
    if b is None:
        return a
    try:
        return T.common_type(a, b)
    except TypeError:
        return a
