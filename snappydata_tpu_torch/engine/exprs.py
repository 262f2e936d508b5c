"""Expression -> tensor lowering with three-valued (SQL NULL) logic.

Port of snappydata_tpu/engine/exprs.py without its ARRAY / MAP / STRUCT
functions and UDFs (the port's catalog holds no such columns yet):
column refs, tokenized literals as runtime scalars, + - * / %,
comparisons, BETWEEN, AND/OR/NOT with Kleene logic, IS NULL, CASE WHEN,
casts, IN lists (a literal list longer than 8 as a sorted probe), string
= / < / IN / LIKE through host-built dictionary lookup tables, the scalar
numeric and date functions (`_emit_func`, civil-calendar integer math),
string functions as derived dictionaries and int LUTs
(`_emit_string_func`), the code/run-domain compare lane
(`_compressed_cmp`) and exact decimals as scaled int64 values (`_dec_*`).
Anything else raises CompileError, which the executor turns into the
reference's host fallback (engine/hosteval.py).

Design, as in the reference:
- Values are (value, null) pairs; null masks exist only where a source
  is nullable.
- Strings never reach the device: a string column is int32 dictionary
  codes, and a predicate `str_col OP literal` evaluates ONCE over the host
  dictionary into a bool lookup table applied as one gather.  A string
  function of one column (upper(concat(s, '_x'))) keeps the column's codes
  and carries a derived dictionary, or an int LUT for length / instr /
  ascii / to_date.
- Tokenized literals arrive as 0-dim tensors, so a changed literal reuses
  the compiled plan.

Emission is two-phase: `ExprBuilder.emit` runs structurally (no tensors),
registering aux-input builders and returning a closure; the closure runs
at execution time over the bound plates.  PyTorch runs eagerly, so
"compiling" a plan only builds these closures.
"""

from __future__ import annotations

import contextvars
import datetime
import dataclasses
import functools
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


# string-valued functions computable per dictionary value on the host and
# carried as derived dictionaries (the codes never leave the device)
STRING_VALUE_FUNCS = frozenset(
    {"upper", "lower", "trim", "ltrim", "rtrim", "substr", "substring",
     "replace", "concat", "lpad", "rpad", "initcap", "repeat", "reverse",
     "translate", "split_part"})
# string functions with an int (DATE for to_date) value: int LUT gathers
_STRING_INT_FUNCS = ("length", "instr", "ascii", "to_date")

# the ONLY functions that may consume an ARRAY / MAP / STRUCT column on the
# device (their plate layouts are opaque to every other operator);
# executor._validate_array_usage enforces the same set
ARRAY_DEVICE_FUNCS = ("size", "element_at", "array_contains")


@dataclasses.dataclass
class MapDicts:
    """Dictionary providers of a device-plated MAP<STRING, V> column: key
    codes always, value codes when V is string."""

    key: Callable[[], np.ndarray]
    value: Optional[Callable[[], np.ndarray]] = None


@dataclasses.dataclass
class StructDicts:
    """Per-field value-dictionary providers of a device-plated STRUCT
    column (string fields only)."""

    fields: Dict[str, Callable[[], np.ndarray]] = None


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


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL `%` with the reference's semantics (jnp `%`): the sign follows
    the divisor, and an integer zero divisor gives 0 on every device (an
    integer division by zero raises on the CPU and leaves an undefined
    value on CUDA, so the divisor is guarded before it divides).  A float
    zero divisor gives NaN, as jnp does."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, torch.zeros_like(a), torch.remainder(a, safe))


_ARITH = {"+": torch.add, "-": torch.sub, "*": torch.mul, "%": _remainder}


# per-execution tally of compressed-domain lowerings: the executor
# installs a dict here around each emitter run (CompiledPlan._noted_call)
# and bumps the code_domain_predicates / rle_run_predicates counters by it
_compressed_notes: contextvars.ContextVar = contextvars.ContextVar(
    "compressed_notes", default=None)


def _note_compressed(kind: str) -> None:
    d = _compressed_notes.get()
    if d is not None:
        d[kind] = d.get(kind, 0) + 1


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
        _note_compressed("code_preds")
        return DVal(m, _or_null(col.null, lit.null), T.BOOLEAN)
    vals = col.rplate.values
    dt = promote(vals.dtype, lit.value.dtype)
    run_mask = _CMP[op](vals.to(dt), lit.value.to(dt))
    out = DVal(rle_expand_runs(run_mask, col.rplate.ends, col.cap),
               _or_null(col.null, lit.null), T.BOOLEAN)
    _note_compressed("run_preds")
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


def _udf_plate(v: torch.Tensor, ret: T.DataType) -> torch.Tensor:
    """A UDF body's result follows torch promotion; cast it to the plate
    dtype of its declared RETURNS type under the dtype policy (exact
    decimals and strings keep what the body gave)."""
    if ret.name in ("string", "array", "map", "struct") or \
            getattr(ret, "is_exact", False):
        return v
    return v.to(T.torch_dtype(ret.device_dtype()))


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

    def _dict_lut(self, col_idx: int,
                  fn: Callable[[np.ndarray, tuple], np.ndarray],
                  dtype=np.bool_) -> int:
        """Register a LUT of `dtype` over the column's dictionary (one
        entry per value, `fn(dictionary, params)`), padded with zeros to a
        power of two so dictionary growth rarely changes its shape."""
        if col_idx not in self.dict_getters:
            raise CompileError("string column without a dictionary")
        getter = self.dict_getters[col_idx]

        def build(params):
            lut = np.asarray(fn(getter(), params)).astype(dtype)
            n = max(1, len(lut))
            padded = 1 << (n - 1).bit_length()
            if padded > len(lut):
                lut = np.concatenate([lut, np.zeros(padded - len(lut),
                                                    dtype=dtype)])
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
                # string params only appear inside string predicates and
                # derived dictionaries, which read them at bind time; a
                # bare string param has no device value
                return _raise_on_run(
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

        if isinstance(e, ast.Func):
            return self._emit_func(e)

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
            # a function may emit its string-literal arguments without
            # running them (substr, replace, concat read them at compile
            # time): only running one raises
            return _raise_on_run(
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
        # (a derivable string expression of one column compares through a
        # LUT over that column's dictionary: upper(s) = 'XYZ')
        if op in _CMP:
            lcol = self._string_operand_info(e.left)
            rcol = self._string_operand_info(e.right)
            if self._is_literalish(e.right):
                ci, fnt = self._try_string_transform(e.left)
                if ci is not None:
                    return self._emit_string_cmp(ci, op, e.right, fnt)
            if self._is_literalish(e.left):
                ci, fnt = self._try_string_transform(e.right)
                if ci is not None:
                    return self._emit_string_cmp(ci, _FLIP_CMP[op], e.left,
                                                 fnt)
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

    def _try_string_transform(self, e: ast.Expr):
        """(col_idx, value fn) when e is a derivable string expression of
        one column (a raw column included), else (None, None)."""
        try:
            ci, fnt = self._string_value_transform(e)
        except CompileError:
            return None, None
        return (ci, fnt) if ci is not None else (None, None)

    def _emit_string_cmp(self, col_idx: int, op: str, lit_expr,
                         transform=None) -> Callable[[Runtime], DVal]:
        get_lit = (lambda params: self._param_value(lit_expr, params))
        ops = {"=": np.equal, "!=": np.not_equal,
               "<": np.less, "<=": np.less_equal,
               ">": np.greater, ">=": np.greater_equal}
        cmp = ops[op]
        fnt = transform or (lambda v: v)

        def one(v, params):
            tv = fnt(v)
            return tv is not None and bool(cmp(tv, get_lit(params)))

        aux_i = self._dict_lut(
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

    def _lut_runner(self, col_idx: int, aux_i: int,
                    out_type: T.DataType = T.BOOLEAN, tdt=None
                    ) -> Callable[[Runtime], DVal]:
        """Gather a `_dict_lut` by the column's codes: a value of
        `out_type` per row (cast to the torch dtype `tdt` when given),
        NULL where the column is."""
        def run(rt: Runtime) -> DVal:
            c = rt.cols[col_idx]
            codes = c.value
            v = torch.index_select(rt.aux[aux_i], 0, codes.reshape(-1)) \
                .reshape(codes.shape)
            if tdt is not None:
                v = v.to(tdt)
            return DVal(v, c.null, out_type)

        return run

    def _emit_in(self, e: ast.InList) -> Callable[[Runtime], DVal]:
        negated = e.negated
        col_idx = self._string_operand_info(e.child)
        if col_idx is not None:
            getters = [(lambda params, x=v: self._param_value(x, params))
                       for v in e.values]
            aux_i = self._dict_lut(
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

        if len(e.values) > 8 and all(self._is_literalish(v)
                                     for v in e.values):
            return self._emit_in_sorted(e)
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

    def _emit_in_sorted(self, e: ast.InList) -> Callable[[Runtime], DVal]:
        """A literal list longer than 8 (an IN subquery's result): the
        values sort once per parameter set into an aux tensor padded to a
        power of two by repeating the last value, and each row probes it
        with searchsorted — O(log k) work a row, one aux upload a bind.
        Float64 when either side is a float, even on CUDA: float32 would
        alias distinct integer keys; int64 otherwise."""
        negated = e.negated
        getters = [(lambda params, x=v: self._param_value(x, params))
                   for v in e.values]

        def build_sorted(params):
            vals = np.asarray([g(params) for g in getters])
            vals = np.sort(vals.astype(np.float64)
                           if vals.dtype == object else vals)
            pad = (1 << (len(vals) - 1).bit_length()) - len(vals)
            if pad:
                vals = np.concatenate([vals, np.full(pad, vals[-1])])
            return vals

        aux_i = self._register_aux(build_sorted)
        child = _dec_wrap_unscaled(self.emit(e.child))

        def run_in_sorted(rt: Runtime) -> DVal:
            c = child(rt)
            table = rt.aux[aux_i]
            # compare in the PROMOTED dtype: truncating a float probe to
            # an int table would produce false positives
            if c.value.is_floating_point() or table.is_floating_point():
                table_c = table.to(torch.float64)
                cv = c.value.to(torch.float64)
            else:
                table_c = table.to(torch.int64)
                cv = c.value.to(torch.int64)
            pos = torch.searchsorted(table_c, cv.contiguous()).clamp_(
                0, table_c.shape[0] - 1)
            hit = table_c[pos] == cv
            if negated:
                hit = ~hit
            return DVal(hit, c.null, T.BOOLEAN)

        return run_in_sorted

    def _emit_like(self, e: ast.Like) -> Callable[[Runtime], DVal]:
        """`str_expr [NOT] LIKE pattern`: one bool LUT over the column's
        dictionary, like every string predicate (the expression may be a
        derivable transform of the column: lower(s) LIKE 'abc%')."""
        col_idx, fnt = self._try_string_transform(e.child)
        if col_idx is None:
            raise CompileError("LIKE requires a string column")
        # SQL LIKE: % = any run, _ = any single char
        regex = re.compile(
            "^" + re.escape(e.pattern).replace("%", ".*").replace("_", ".")
            .replace("\\%", "%").replace("\\_", "_") + "$", re.DOTALL)
        negated = e.negated

        def one(v):
            tv = fnt(v)
            return tv is not None and regex.match(tv) is not None

        aux_i = self._dict_lut(
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
        if to.name == "string":
            raise CompileError("CAST to string not supported on device")
        if isinstance(to, (T.ArrayType, T.MapType, T.StructType)):
            raise CompileError(f"CAST to {to} not supported on device")
        src_col = self._string_operand_info(e.child)
        if src_col is not None:
            return self._emit_string_cast(src_col, to)
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


    def _emit_string_cast(self, col_idx: int, to: T.DataType
                          ) -> Callable[[Runtime], DVal]:
        """CAST(string column AS numeric / DATE / TIMESTAMP / BOOLEAN):
        each dictionary value converts once on the host, by the host
        evaluator's own rule (`astype` of the target's numpy type), into
        a LUT gathered by code.  A value that does not convert reroutes
        the query to the host path, which raises as the host does."""
        if _is_exact_decimal(to):
            raise CompileError("CAST of a string to an exact decimal: "
                               "host path")
        np_dt = np.dtype(to.np_dtype)

        def convert(d, params):
            present = np.array([v is not None for v in d], dtype=np.bool_)
            lut = np.zeros(len(d), dtype=np_dt)
            try:
                lut[present] = np.asarray(
                    [v for v in d if v is not None],
                    dtype=object).astype(np_dt)
            except (ValueError, TypeError, OverflowError) as ex:
                raise CompileError(
                    f"CAST of a string that does not convert: {ex}")
            return lut

        aux_i = self._dict_lut(col_idx, convert, np_dt)
        return self._lut_runner(col_idx, aux_i, to,
                                T.torch_dtype(to.device_dtype()))

    def _string_value_transform(self, e: ast.Expr):
        """(col_idx | None, fn: dictionary value -> derived value) for a
        string-valued expression computable from ONE column's dictionary
        values plus literals, compositions like upper(concat(s, '_x'))
        included.  col_idx None means literal-only.  Raises CompileError
        when not derivable (two columns, non-literal args, ...)."""
        if isinstance(e, ast.Alias):
            return self._string_value_transform(e.child)
        if isinstance(e, ast.Lit):
            lit = None if e.value is None else str(e.value)
            return None, lambda v: lit
        ci = self._string_operand_info(e)
        if ci is not None:
            return ci, lambda v: v
        if not isinstance(e, ast.Func) or \
                e.name not in STRING_VALUE_FUNCS:
            raise CompileError("not a derivable string expression")
        name = e.name
        if name == "concat":
            parts = [self._string_value_transform(a) for a in e.args]
            cis = {c for c, _ in parts if c is not None}
            if len(cis) > 1:
                raise CompileError("concat over two string columns")

            def fn_concat(v, parts=parts):
                out = []
                for _, pf in parts:
                    pv = pf(v)
                    if pv is None:   # SQL concat: any NULL -> NULL
                        return None
                    out.append(pv)
                return "".join(out)

            return (cis.pop() if cis else None), fn_concat
        ci, base = self._string_value_transform(e.args[0])
        extra = []
        for a in e.args[1:]:
            if not isinstance(a, ast.Lit):
                raise CompileError(f"{name} with non-literal args")
            extra.append(a.value)
        if name == "replace" and (not extra or extra[0] is None or (
                len(extra) > 1 and extra[1] is None)):
            # NULL search / replacement -> NULL result (Spark): the host
            # path implements that
            raise CompileError("replace with NULL argument")
        if name == "split_part" and len(extra) > 1 \
                and extra[1] is not None and int(extra[1]) == 0:
            raise CompileError("split_part index must not be 0")
        op = functools.partial(_string_value_op, name, extra)
        return ci, lambda v: op(base(v))

    def _arg_typed_col(self, e: ast.Expr, type_cls):
        """(dtype, column ordinal) of an argument that is (an alias of) a
        raw column of `type_cls`, else (None, None)."""
        if isinstance(e, ast.Alias):
            return self._arg_typed_col(e.child, type_cls)
        if isinstance(e, ast.Col):
            dt = e.dtype if e.dtype is not None else \
                self.col_types.get(e.index)
            if isinstance(dt, type_cls):
                return dt, e.index
        return None, None

    def _literal_code_aux(self, lit_expr, getter) -> int:
        """Register an aux tensor resolving a literal at bind time to
        [dictionary code, needle is NULL]: -1 = absent (matches no code);
        a NULL literal flags [1] == 1 so the runners propagate NULL."""
        def build(params, getter=getter):
            lit = self._param_value(lit_expr, params)
            if lit is None:
                return np.array([-1, 1], np.int32)
            hit = np.flatnonzero(
                np.asarray(getter(), dtype=object) == str(lit))
            return np.array([hit[0] if hit.size else -1, 0], np.int32)

        return self._register_aux(build)

    def _emit_struct_field(self, e: ast.Func, s0, s_ci, arr_run):
        """element_at(struct, 'field'): the field name is STRUCTURAL
        (tokenization keeps it a literal) and picks one [B, C] plate at
        compile time."""
        sdicts = self.dict_getters.get(s_ci)
        if not isinstance(sdicts, StructDicts):
            raise CompileError("struct column without device plates: "
                               "host path")
        if not isinstance(e.args[1], ast.Lit):
            raise CompileError("element_at over a struct needs a literal "
                               "field name: host path")
        want = str(e.args[1].value).lower()
        fidx = next((k for k, (fn, _t) in enumerate(s0.fields)
                     if fn.lower() == want), None)
        if fidx is None:
            raise CompileError(f"no struct field {want!r}: host path")
        fname, ftype = s0.fields[fidx]

        def run_sfield(rt: Runtime) -> DVal:
            d = arr_run(rt)
            fvals, fnuls = d.value
            return DVal(fvals[fidx], _or_null(d.null, fnuls[fidx]), ftype,
                        dictionary=sdicts.fields.get(fname)
                        if ftype.name == "string" else None)

        return run_sfield

    def _emit_map_func(self, e: ast.Func, m0, m_ci, arr_run):
        """size(map) and element_at(map, 'key') over key-code plates: the
        literal key resolves to its key-dictionary CODE at bind; the first
        matching entry's value answers, NULL for a missing key, a NULL
        key or a NULL value."""
        mdicts = self.dict_getters.get(m_ci)
        if not isinstance(mdicts, MapDicts):
            raise CompileError("map column without device plates: "
                               "host path")
        if e.name == "size":
            def run_msize(rt: Runtime) -> DVal:
                d = arr_run(rt)
                _k, _v, lengths, _vn = d.value
                return DVal(lengths.to(torch.int32), d.null, T.INT)

            return run_msize
        if not self._is_literalish(e.args[1]):
            raise CompileError("element_at over a map needs a literal "
                               "key: host path")
        aux_i = self._literal_code_aux(e.args[1], mdicts.key)
        val_t = m0.value
        val_is_str = val_t.name == "string"

        def run_melem(rt: Runtime) -> DVal:
            d = arr_run(rt)
            kcodes, vals, lengths, vnul = d.value
            L = kcodes.shape[-1]
            code = rt.aux[aux_i][0]
            key_null = rt.aux[aux_i][1] == 1
            in_range = torch.arange(L, device=kcodes.device) \
                < lengths[..., None]
            hit = (kcodes == code) & in_range
            found = hit.any(dim=-1)
            idx = torch.argmax(hit.to(torch.uint8), dim=-1,
                               keepdim=True)
            out = torch.gather(vals, -1, idx)[..., 0]
            vn = torch.gather(vnul, -1, idx)[..., 0]
            null = _or_null(d.null, ~found | vn | key_null.expand(
                found.shape))
            return DVal(out, null, val_t,
                        dictionary=mdicts.value if val_is_str else None)

        return run_melem

    def _emit_array_func(self, e: ast.Func, t0, a_ci, arr_run, other):
        """size / element_at / array_contains over array plates (values
        [.., L], lengths, element nulls): padding and NULL elements are
        excluded through the length and element-null masks.  A position
        past the length or a NULL element gives NULL; string needles
        resolve to element-dictionary codes at bind."""
        is_str_elem = t0.element.name == "string"
        elem_dict = self.dict_getters.get(a_ci) if a_ci is not None \
            else None
        if not T.is_numeric(t0.element) and not (
                is_str_elem and elem_dict is not None):
            raise CompileError("array element type has no device plates: "
                               "host path")
        if e.name == "size":
            def run_size(rt: Runtime) -> DVal:
                d = arr_run(rt)
                _vals, lengths, _en = d.value
                return DVal(lengths.to(torch.int32), d.null, T.INT)

            return run_size
        if e.name == "element_at":
            def run_elem(rt: Runtime) -> DVal:
                d = arr_run(rt)
                iv = other(rt)
                vals, lengths, enul = d.value
                pos = torch.as_tensor(iv.value, device=vals.device).to(
                    torch.int64) - 1
                pos_b = pos.expand(lengths.shape)
                safe = pos_b.clamp(0, vals.shape[-1] - 1)[..., None]
                out = torch.gather(vals, -1, safe)[..., 0]
                el_null = torch.gather(enul, -1, safe)[..., 0]
                bad = (pos_b < 0) | (pos_b >= lengths) | el_null
                # string elements are CODES: the DVal carries the element
                # dictionary so projections decode
                return DVal(out, _or_null(_or_null(d.null, iv.null), bad),
                            t0.element,
                            dictionary=elem_dict if is_str_elem else None)

            return run_elem
        if is_str_elem:
            # array_contains(a, 'lit'): the needle's element-dictionary
            # CODE at bind (an absent value -> -1, which no code matches)
            if not self._is_literalish(e.args[1]):
                raise CompileError("array_contains over a string array "
                                   "needs a literal needle: host path")
            aux_i = self._literal_code_aux(e.args[1], elem_dict)

            def run_contains_str(rt: Runtime) -> DVal:
                d = arr_run(rt)
                vals, lengths, enul = d.value
                L = vals.shape[-1]
                code = rt.aux[aux_i][0]
                needle_null = rt.aux[aux_i][1] == 1
                in_range = (torch.arange(L, device=vals.device)
                            < lengths[..., None]) & ~enul
                out = ((vals == code) & in_range).any(dim=-1)
                return DVal(out, _or_null(d.null,
                                          needle_null.expand(out.shape)),
                            T.BOOLEAN)

            return run_contains_str
        exact_elem = _is_exact_decimal(t0.element)

        def run_contains(rt: Runtime) -> DVal:
            d = arr_run(rt)
            xv = other(rt)
            vals, lengths, enul = d.value
            L = vals.shape[-1]
            needle = torch.as_tensor(xv.value, device=vals.device)
            if exact_elem and not vals.is_floating_point():
                # element plates hold SCALED ints: the needle scales the
                # same way (HALF_UP)
                nf = needle.to(torch.float64) * (10 ** t0.element.scale)
                needle = (torch.sign(nf) * torch.floor(nf.abs() + 0.5)
                          ).to(torch.int64)
            x = needle.expand(lengths.shape)
            # compare under type promotion: a fractional needle must not
            # truncate into the int element domain
            eq = vals == x[..., None]
            in_range = (torch.arange(L, device=vals.device)
                        < lengths[..., None]) & ~enul
            out = (eq & in_range).any(dim=-1)
            return DVal(out, _or_null(d.null, xv.null), T.BOOLEAN)

        return run_contains

    def _emit_func(self, e: ast.Func) -> Callable[[Runtime], DVal]:
        """Scalar functions (ref snappydata_tpu/engine/exprs.py
        `_emit_func`, without UDFs), with the device lowering of size /
        element_at / array_contains over ARRAY / MAP / STRUCT plates."""
        name = e.name
        if name in ast.AGG_FUNCS:
            raise CompileError(
                f"aggregate {name} outside aggregation context")
        # scalar functions consume exact decimals in the plain float
        # domain: their value math (round, sqrt, coalesce with literals)
        # is blind to the scaled-int representation.  Aggregates never
        # reach here (the executor sums them exactly).
        args = [_dec_wrap_unscaled(self.emit(a)) for a in e.args]

        if name in ARRAY_DEVICE_FUNCS and e.args:
            if name == "element_at" and len(e.args) == 2:
                s0, s_ci = self._arg_typed_col(e.args[0], T.StructType)
                if s0 is not None:
                    return self._emit_struct_field(e, s0, s_ci, args[0])
            if name in ("size", "element_at"):
                m0, m_ci = self._arg_typed_col(e.args[0], T.MapType)
                if m0 is not None:
                    return self._emit_map_func(e, m0, m_ci, args[0])
            t0, a_ci = self._arg_typed_col(e.args[0], T.ArrayType)
            if t0 is not None:
                return self._emit_array_func(
                    e, t0, a_ci, args[0], args[1] if len(args) > 1
                    else None)

        if name == "coalesce":
            def run_coalesce(rt: Runtime) -> DVal:
                vals = [a(rt) for a in args]
                out = vals[-1]
                acc_v, acc_n = out.value, out.null
                for v in reversed(vals[:-1]):
                    dt = promote(acc_v.dtype, v.value.dtype)
                    isnull = v.null if v.null is not None else \
                        torch.zeros((), dtype=torch.bool, device=rt.device)
                    acc_v = torch.where(isnull, acc_v.to(dt),
                                        v.value.to(dt))
                    # NULL only where this argument and every later one
                    # are NULL; a never-NULL argument ends the chain
                    acc_n = None if v.null is None or acc_n is None \
                        else (v.null & acc_n)
                return DVal(acc_v, acc_n, vals[0].dtype)

            return run_coalesce

        if name == "abs":
            return self._unary_math(args[0], torch.abs, keep_type=True)
        if name == "sqrt":
            return self._unary_math(args[0], lambda x: torch.sqrt(
                x.to(float_dtype())))
        if name in ("ln", "log"):
            return self._unary_math(args[0], lambda x: torch.log(
                x.to(float_dtype())))
        if name == "exp":
            return self._unary_math(args[0], lambda x: torch.exp(
                x.to(float_dtype())))
        if name == "round":
            return self._emit_round(e, args)
        if name in ("pow", "power"):
            def run_pow(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                av = a.value.to(float_dtype())
                dt = promote(av.dtype, b.value.dtype)
                return DVal(torch.pow(av.to(dt), b.value.to(dt)),
                            _or_null(a.null, b.null), T.DOUBLE)

            return run_pow

        if name in _DATE_PARTS:
            part = "day" if name == "dayofmonth" else name

            def run_datepart(rt: Runtime) -> DVal:
                c = args[0](rt)
                return DVal(_date_part(part, _to_days(c)).to(torch.int32),
                            c.null, T.INT)

            return run_datepart

        if name in ("hour", "minute", "second"):
            divisor, modulo = {"hour": (3_600_000_000, 24),
                               "minute": (60_000_000, 60),
                               "second": (1_000_000, 60)}[name]

            def run_timepart(rt: Runtime) -> DVal:
                c = args[0](rt)
                if c.dtype is not None and c.dtype.name == "timestamp":
                    out = (c.value // divisor) % modulo
                else:  # DATE has no time component
                    out = torch.zeros_like(c.value)
                return DVal(out.to(torch.int32), c.null, T.INT)

            return run_timepart

        if name in ("date_add", "date_sub"):
            sign = 1 if name == "date_add" else -1

            def run_dateadd(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                out = _to_days(a) + sign * b.value.to(torch.int32)
                return DVal(out.to(torch.int32), _or_null(a.null, b.null),
                            T.DATE)

            return run_dateadd

        if name == "datediff":
            def run_datediff(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                return DVal((_to_days(a) - _to_days(b)).to(torch.int32),
                            _or_null(a.null, b.null), T.INT)

            return run_datediff

        if name == "add_months":
            def run_addmonths(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                y, m, d = _civil_from_days(_to_days(a))
                m0 = y.to(torch.int64) * 12 + (m - 1) + \
                    b.value.to(torch.int64)
                y2 = (m0 // 12).to(torch.int32)
                m2 = (m0 % 12 + 1).to(torch.int32)
                d2 = torch.minimum(d, _days_in_month(y2, m2))
                return DVal(_days_from_civil(y2, m2, d2),
                            _or_null(a.null, b.null), T.DATE)

            return run_addmonths

        if name == "last_day":
            def run_lastday(rt: Runtime) -> DVal:
                c = args[0](rt)
                y, m, _ = _civil_from_days(_to_days(c))
                return DVal(_days_from_civil(y, m, _days_in_month(y, m)),
                            c.null, T.DATE)

            return run_lastday

        if name == "trunc":
            fmt = e.args[1].value if len(e.args) > 1 and \
                isinstance(e.args[1], ast.Lit) else None
            if fmt is None:
                raise CompileError("trunc needs a literal format")
            fmt = str(fmt).upper()
            if fmt not in _TRUNC_FORMATS:
                raise CompileError(f"trunc format {fmt!r}")

            def run_trunc(rt: Runtime) -> DVal:
                c = args[0](rt)
                days = _to_days(c)
                y, m, _ = _civil_from_days(days)
                one = torch.ones_like(m)
                if fmt in ("YEAR", "YYYY", "YY"):
                    out = _days_from_civil(y, one, one)
                elif fmt in ("MONTH", "MM", "MON"):
                    out = _days_from_civil(y, m, one)
                elif fmt in ("QUARTER", "Q"):
                    out = _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
                else:  # WEEK: the ISO Monday
                    out = days - (days + 3) % 7
                return DVal(out.to(torch.int32), c.null, T.DATE)

            return run_trunc

        if name == "months_between":
            def run_mb(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                fd = float_dtype()
                y1, m1, d1 = _civil_from_days(_to_days(a))
                y2, m2, d2 = _civil_from_days(_to_days(b))
                whole = ((y1 - y2) * 12 + (m1 - m2)).to(fd)
                same = (d1 == d2) | ((d1 == _days_in_month(y1, m1))
                                     & (d2 == _days_in_month(y2, m2)))
                frac = torch.where(same, torch.zeros((), dtype=fd,
                                                     device=rt.device),
                                   (d1 - d2).to(fd) / 31.0)
                return DVal(whole + frac, _or_null(a.null, b.null),
                            T.DOUBLE)

            return run_mb

        if name == "unix_timestamp":
            def run_unix(rt: Runtime) -> DVal:
                c = args[0](rt)
                if c.dtype is not None and c.dtype.name == "timestamp":
                    out = c.value // 1_000_000
                else:
                    out = c.value.to(torch.int64) * 86_400
                return DVal(out.to(torch.int64), c.null, T.LONG)

            return run_unix

        if name == "to_date" and args:
            # date / timestamp input: a pure conversion; a string column
            # takes the dictionary int-LUT path below
            try:
                self._string_value_transform(e.args[0])
                string_input = True
            except CompileError:
                string_input = False
            if not string_input:
                def run_todate(rt: Runtime) -> DVal:
                    c = args[0](rt)
                    return DVal(_to_days(c), c.null, T.DATE)

                return run_todate

        if name == "sign":
            return self._unary_math(args[0], lambda x: torch.sign(
                x.to(float_dtype())))
        if name in ("floor", "ceil", "ceiling"):
            tfn = torch.floor if name == "floor" else torch.ceil

            def run_fc(rt: Runtime) -> DVal:
                c = args[0](rt)
                return DVal(tfn(c.value.to(float_dtype())).to(torch.int64),
                            c.null, T.LONG)

            return run_fc
        if name in ("mod", "pmod"):
            positive = name == "pmod"

            def run_mod(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                dt = promote(a.value.dtype, b.value.dtype)
                av, bv = a.value.to(dt), b.value.to(dt)
                zero = bv == 0
                bs = torch.where(zero, torch.ones_like(bv), bv)
                # mod keeps the dividend's sign (Spark %); pmod is >= 0
                out = torch.remainder(torch.remainder(av, bs) + bs, bs) \
                    if positive else torch.fmod(av, bs)
                null = _or_null(_or_null(a.null, b.null),
                                zero.expand(out.shape))
                return DVal(out, null, _promote(a.dtype, b.dtype))

            return run_mod
        if name == "nullif":
            def run_nullif(rt: Runtime) -> DVal:
                a, b = args[0](rt), args[1](rt)
                _no_string_operands((a, b), name)
                dt = promote(a.value.dtype, b.value.dtype)
                eq = a.value.to(dt) == b.value.to(dt)
                if b.null is not None:
                    eq = eq & ~b.null
                return DVal(a.value, eq if a.null is None else (a.null | eq),
                            a.dtype)

            return run_nullif
        if name in ("greatest", "least"):
            pickmax = name == "greatest"

            def run_gl(rt: Runtime) -> DVal:
                dvs = [a(rt) for a in args]
                _no_string_operands(dvs, name)
                dt = None
                for d in dvs:
                    dt = _promote(dt, d.dtype)
                tdt = T.torch_dtype(dt.device_dtype())
                if tdt.is_floating_point:
                    ident = -float("inf") if pickmax else float("inf")
                else:
                    info = torch.iinfo(tdt)
                    ident = info.min if pickmax else info.max
                acc = None
                for d in dvs:
                    v = d.value.to(tdt)
                    if d.null is not None:
                        # a NULL argument is skipped, not contagious
                        v = torch.where(d.null, torch.full(
                            (), ident, dtype=tdt, device=rt.device), v)
                    acc = v if acc is None else (
                        torch.maximum(acc, v) if pickmax
                        else torch.minimum(acc, v))
                if any(d.null is None for d in dvs):
                    out_null = None  # NULL only when EVERY arg is NULL
                else:
                    out_null = dvs[0].null
                    for d in dvs[1:]:
                        out_null = out_null & d.null
                return DVal(acc, out_null, dt)

            return run_gl

        # string functions via derived dictionaries (compositions too:
        # upper(concat(s, '_x')), instr(lower(s), 'q'), ...)
        if name in STRING_VALUE_FUNCS or name in _STRING_INT_FUNCS:
            return self._emit_string_func(e)

        # SQL-registered functions (CREATE FUNCTION): the python body
        # runs on the plates' tensors inside the device program (ref:
        # SnappyDDLParser.scala:765 createFunction).  String arguments
        # stay on the host path: device values are dictionary codes the
        # body must not see
        from snappydata_tpu_torch.sql import udf as _udf

        u = _udf.lookup(name)
        if u is not None:
            from snappydata_tpu_torch.sql.analyzer import expr_type

            for a in e.args:
                try:
                    at = expr_type(a)
                except Exception:
                    at = None
                if at is not None and at.name == "string":
                    raise CompileError(
                        f"UDF {name} over string arguments runs on host")
            ret = u.returns or T.DOUBLE
            fn = u.fn

            def run_udf(rt: Runtime) -> DVal:
                dvs = [a(rt) for a in args]
                # eager execution: a body that fails here (a name outside
                # the device namespace, a numpy call on a card tensor)
                # takes the host lane, as a body failing under the
                # reference's tracing does
                try:
                    with _udf.device_lane(rt.device):
                        v = fn(*[d.value for d in dvs])
                    if not isinstance(v, torch.Tensor):
                        v = torch.as_tensor(np.asarray(v),
                                            device=rt.device)
                except Exception as ex:
                    raise CompileError(f"UDF {name} failed on the device "
                                       f"lane: {ex}")
                out_null = None
                for d in dvs:
                    if d.null is not None:
                        out_null = d.null if out_null is None \
                            else (out_null | d.null)
                return DVal(_udf_plate(v, ret), out_null, ret)

            return run_udf

        raise CompileError(f"unsupported function on device: {name}")

    def _emit_round(self, e: ast.Func, args) -> Callable[[Runtime], DVal]:
        """round(x[, d]): half to even, as jnp.round; negative digits
        divide by the exact integer power (0.001 is not binary-exact)."""
        digits, digits_pos = 0, None
        if len(e.args) == 2 and isinstance(
                e.args[1], (ast.Lit, ast.ParamLiteral, ast.Param)):
            if isinstance(e.args[1], ast.Lit):
                digits = int(e.args[1].value)
            else:  # tokenized literal or prepared '?': a runtime scalar
                digits, digits_pos = None, e.args[1].pos

        def run_round(rt: Runtime) -> DVal:
            c = args[0](rt)
            v = c.value
            if digits is not None:  # static digits
                # a Python scalar keeps a float plate's width, as jnp's
                # weak typing does; an integer plate meets it at float64
                if not v.is_floating_point():
                    v = v.to(torch.float64)
                if digits >= 0:
                    mult = float(10 ** digits)
                    out = torch.round(v * mult) / mult
                else:
                    scale = float(10 ** (-digits))
                    out = torch.round(v / scale) * scale
            else:
                d = rt.params[digits_pos].to(torch.float64)
                scale = torch.round(torch.pow(10.0, d.abs()))
                # the float64 scale widens a float32 plate, as in jnp;
                # torch would keep the product in float32
                v = v.to(promote(v.dtype, scale.dtype))
                out = torch.where(d >= 0, torch.round(v * scale) / scale,
                                  torch.round(v / scale) * scale)
            return DVal(out, c.null, c.dtype)

        return run_round

    def _unary_math(self, arg, fn, keep_type=False):
        def run(rt: Runtime) -> DVal:
            c = arg(rt)
            return DVal(fn(c.value), c.null,
                        c.dtype if keep_type else T.DOUBLE)

        return run

    def _emit_string_func(self, e: ast.Func) -> Callable[[Runtime], DVal]:
        """String expressions as DERIVED DICTIONARIES: the codes stay on
        the device untouched and the per-value transform runs once over
        the (small) dictionary on the host.  length / instr / ascii /
        to_date lower to int LUT gathers so they compose with device
        filters and group keys."""
        name = e.name
        if name in _STRING_INT_FUNCS:
            col_idx, base = self._string_value_transform(e.args[0])
            if col_idx is None:
                raise CompileError(f"{name} of literal-only expression")
            if name == "instr" and (len(e.args) < 2
                                    or not isinstance(e.args[1], ast.Lit)):
                raise CompileError("instr with non-literal needle")
            needle = str(e.args[1].value) if name == "instr" else None
            val_of = functools.partial(_string_int_value, name, base,
                                       needle)
            aux_i = self._dict_lut(
                col_idx, lambda d, params: [val_of(v) for v in d],
                np.int32)
            if name != "to_date":
                return self._lut_runner(col_idx, aux_i, T.INT)
            base = self._lut_runner(col_idx, aux_i, T.DATE)

            def run_to_date(rt: Runtime) -> DVal:
                r = base(rt)   # unparseable -> NULL via the sentinel
                bad = r.value == _BAD_DATE
                return DVal(torch.where(bad, torch.zeros_like(r.value),
                                        r.value),
                            _or_null(r.null, bad), T.DATE)

            return run_to_date

        col_idx, fn = self._string_value_transform(e)
        if col_idx is None:
            raise CompileError("literal-only string expression")
        getter = self.dict_getters[col_idx]

        def derived_dict():
            # a CALLABLE dictionary, re-derived from the CURRENT table
            # dictionary at assemble time, so codes minted after this
            # plan compiled still decode
            return np.array([fn(v) for v in getter()], dtype=object)

        def run_strfn(rt: Runtime) -> DVal:
            c = rt.cols[col_idx]
            return DVal(c.value, c.null, T.STRING, dictionary=derived_dict)

        return run_strfn

def _promote(a: Optional[T.DataType], b: Optional[T.DataType]) -> T.DataType:
    if a is None:
        return b or T.DOUBLE
    if b is None:
        return a
    try:
        return T.common_type(a, b)
    except TypeError:
        return a


def _raise_on_run(msg: str) -> Callable[[Runtime], DVal]:
    """An emitted value that has no device form: emitting it is fine (a
    function reads its literal arguments structurally), running it raises
    CompileError, which reroutes the query to the host path."""

    def run(rt: Runtime) -> DVal:
        raise CompileError(msg)

    return run


def _no_string_operands(dvals, name: str) -> None:
    for d in dvals:
        if d.dtype is not None and d.dtype.name == "string":
            raise CompileError(f"{name} over strings: host path")


def _string_value_op(name: str, extra: list, v):
    """One STRING_VALUE_FUNCS transform of one dictionary value (None is
    SQL NULL); `extra` holds the function's literal arguments."""
    if v is None:
        return None
    if name == "upper":
        return v.upper()
    if name == "lower":
        return v.lower()
    if name == "trim":
        return v.strip()
    if name == "ltrim":
        return v.lstrip()
    if name == "rtrim":
        return v.rstrip()
    if name in ("substr", "substring"):
        start = int(extra[0]) - 1 if extra and extra[0] is not None else 0
        ln = int(extra[1]) if len(extra) > 1 and extra[1] is not None \
            else None
        return v[start:start + ln] if ln is not None else v[start:]
    if name == "replace":
        return v.replace(str(extra[0]),
                         str(extra[1]) if len(extra) > 1 else "")
    if name in ("lpad", "rpad"):
        n2 = int(extra[0])
        if n2 <= 0:
            return ""
        pad = str(extra[1]) if len(extra) > 1 and extra[1] is not None \
            else " "
        if len(v) >= n2:
            return v[:n2]
        fill = (pad * n2)[:n2 - len(v)] if pad else ""
        return fill + v if name == "lpad" else v + fill
    if name == "initcap":
        return " ".join(p[:1].upper() + p[1:].lower() for p in v.split(" "))
    if name == "repeat":
        return v * max(0, int(extra[0]))
    if name == "reverse":
        return v[::-1]
    if name == "translate":
        frm = str(extra[0]) if extra and extra[0] is not None else ""
        to = str(extra[1]) if len(extra) > 1 and extra[1] is not None else ""
        return v.translate({ord(f): (to[i] if i < len(to) else None)
                            for i, f in enumerate(frm)})
    if name == "split_part":
        delim = str(extra[0])
        idx = int(extra[1])
        parts = v.split(delim) if delim else [v]
        pos = idx - 1 if idx > 0 else len(parts) + idx
        return parts[pos] if 0 <= pos < len(parts) else ""
    raise CompileError(name)


_BAD_DATE = int(np.iinfo(np.int32).min)   # unparseable to_date sentinel
_EPOCH_ORDINAL = datetime.date(1970, 1, 1).toordinal()


def _string_int_value(name: str, base, needle, v) -> int:
    """One int-LUT entry of length / instr / ascii / to_date."""
    bv = base(v)
    if name == "instr":
        return bv.find(needle) + 1 if bv is not None else 0
    if name == "ascii":
        return ord(bv[0]) if bv else 0
    if name == "to_date":
        if bv is None:
            return _BAD_DATE
        try:
            return datetime.date.fromisoformat(
                str(bv)[:10]).toordinal() - _EPOCH_ORDINAL
        except ValueError:
            return _BAD_DATE
    return len(bv) if bv is not None else 0   # length


# ---------------------------------------------------------------------------
# Civil-calendar arithmetic on days since 1970-01-01 (int32 in, int32 out;
# int64 inside), Howard Hinnant's public-domain algorithms.  torch's `//`
# and `%` floor like Python's, as jnp's do.
# ---------------------------------------------------------------------------

def _to_days(c: DVal) -> torch.Tensor:
    """DATE / TIMESTAMP DVal -> days since the epoch, int32."""
    if c.dtype is not None and c.dtype.name == "timestamp":
        return (c.value // 86_400_000_000).to(torch.int32)
    return c.value.to(torch.int32)


def _days_from_civil(y, m, d) -> torch.Tensor:
    """(year, month, day) -> days since the epoch (the inverse of
    _civil_from_days)."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = (153 * mp + 2) // 5 + d.to(torch.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _days_in_month(y, m) -> torch.Tensor:
    dim = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=torch.int32, device=m.device)[m.long() - 1]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return torch.where((m == 2) & leap, 29, dim).to(torch.int32)


def _civil_from_days(days):
    """Days since the epoch -> (year, month, day), int32 each."""
    z = days.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


_DATE_PARTS = ("year", "month", "day", "dayofmonth", "quarter",
               "dayofyear", "dayofweek", "weekofyear")
_TRUNC_FORMATS = ("YEAR", "YYYY", "YY", "MONTH", "MM", "MON", "QUARTER",
                  "Q", "WEEK")


def _date_part(part: str, days: torch.Tensor) -> torch.Tensor:
    y, m, d = _civil_from_days(days)
    if part == "year":
        return y
    if part == "month":
        return m
    if part == "day":
        return d
    if part == "quarter":
        return (m + 2) // 3
    if part == "dayofyear":
        return days - _days_from_civil(y, torch.ones_like(m),
                                       torch.ones_like(d)) + 1
    if part == "dayofweek":
        # Spark: 1 = Sunday .. 7 = Saturday (1970-01-01 was a Thursday)
        return (days + 4) % 7 + 1
    # weekofyear: the ISO-8601 week, by the Thursday of the row's week
    wd = (days + 3) % 7 + 1
    thu = days + (4 - wd)
    ty, _, _ = _civil_from_days(thu)
    one = torch.ones_like(ty)
    return (thu - _days_from_civil(ty, one, one)) // 7 + 1
