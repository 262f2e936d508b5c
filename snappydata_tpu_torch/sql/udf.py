"""SQL-registered scalar functions (UDFs).

Port of snappydata_tpu/sql/udf.py.  CREATE FUNCTION registers a named
function callable inside SQL expressions (SnappyDDLParser.scala:765
createFunction; there a JVM class from a jar, here a Python expression
over array values).  On the device lane the body runs on the plates'
tensors inside the query's device program (`engine/exprs.py` `run_udf`);
the host evaluator calls the same body on numpy arrays.

    CREATE FUNCTION taxed AS 'lambda price, rate: price * (1 + rate)'
        RETURNS DOUBLE
    SELECT taxed(l_extendedprice, l_tax) FROM lineitem

The body is a Python lambda (or a named-function expression) operating
elementwise, compiled with `eval` in a restricted namespace: `jnp`, `np`,
`math`, `torch` and six builtins.  `jnp` is not JAX here: it is the small
namespace `JNP` below, which holds the elementwise functions a SQL scalar
body uses (`clip`, `where`, `abs`, `sqrt`, `exp`, `log`, `log1p`,
`floor`, `ceil`, `round`, `sign`, `maximum`, `minimum`, `power`, `isnan`,
`asarray`) and dispatches on its arguments: torch ops for tensors,
numpy for arrays.  So bodies written for the reference run unchanged, and
a data directory the reference wrote recovers here.  On the device lane
a `jnp` name outside that set raises AttributeError, which the lowering
turns into CompileError (the host lane takes over, as the reference does
when a body fails under tracing); on the host lane it resolves to numpy's
function of that name.  Creating a function is a code-execution surface,
gated like EXEC PYTHON on network-derived sessions.

Functions live in `catalog._functions` (persisted through aux DDL
replay); the active catalog's registry reaches the expression compilers
through a contextvar that the session installs around each query.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from snappydata_tpu_torch import types as T


@dataclasses.dataclass
class UdfDef:
    name: str
    body: str
    returns: Optional[T.DataType]
    fn: Callable


_active: contextvars.ContextVar = contextvars.ContextVar(
    "udf_registry", default=None)
# the torch device of the device lane while a body runs there; None on
# the host lane
_lane: contextvars.ContextVar = contextvars.ContextVar(
    "udf_device_lane", default=None)


@contextlib.contextmanager
def using(catalog):
    """Install `catalog`'s function registry for the current execution
    (expression compilation and host evaluation read it via lookup())."""
    tok = _active.set(getattr(catalog, "_functions", None))
    try:
        yield
    finally:
        _active.reset(tok)


@contextlib.contextmanager
def device_lane(device):
    """Mark a body call as running on the device lane over `device`."""
    tok = _lane.set(device)
    try:
        yield
    finally:
        _lane.reset(tok)


def lookup(name: str) -> Optional[UdfDef]:
    reg = _active.get()
    if not reg:
        return None
    return reg.get(name.lower())


def _tensors(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=like.device)


def _first_tensor(*xs) -> torch.Tensor:
    return next(x for x in xs if isinstance(x, torch.Tensor))


def _unary(tfn, nfn):
    def f(x):
        return tfn(x) if isinstance(x, torch.Tensor) else nfn(x)
    return f


def _binary(tfn, nfn):
    def f(a, b):
        if _tensors(a, b):
            t = _first_tensor(a, b)
            return tfn(_as_tensor(a, t), _as_tensor(b, t))
        return nfn(a, b)
    return f


def _where(c, a, b):
    if _tensors(c, a, b):
        t = _first_tensor(c, a, b)
        return torch.where(_as_tensor(c, t).to(torch.bool),
                           _as_tensor(a, t), _as_tensor(b, t))
    return np.where(c, a, b)


def _clip(x, lo=None, hi=None):
    if isinstance(x, torch.Tensor):
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
            return torch.clamp(x, min=None if lo is None
                               else _as_tensor(lo, x),
                               max=None if hi is None
                               else _as_tensor(hi, x))
        return torch.clamp(x, min=lo, max=hi)
    return np.clip(x, lo, hi)


def _asarray(x, dtype=None):
    dev = _lane.get()
    if dev is not None:
        t = torch.as_tensor(x, device=dev)
        return t if dtype is None else t.to(T.torch_dtype(np.dtype(dtype)))
    return np.asarray(x, dtype=dtype)


class _Jnp:
    """The `jnp` of a UDF body in the port (see the module docstring)."""

    clip = staticmethod(_clip)
    where = staticmethod(_where)
    abs = staticmethod(_unary(torch.abs, np.abs))
    sqrt = staticmethod(_unary(torch.sqrt, np.sqrt))
    exp = staticmethod(_unary(torch.exp, np.exp))
    log = staticmethod(_unary(torch.log, np.log))
    log1p = staticmethod(_unary(torch.log1p, np.log1p))
    floor = staticmethod(_unary(torch.floor, np.floor))
    ceil = staticmethod(_unary(torch.ceil, np.ceil))
    round = staticmethod(_unary(torch.round, np.round))
    sign = staticmethod(_unary(torch.sign, np.sign))
    isnan = staticmethod(_unary(torch.isnan, np.isnan))
    maximum = staticmethod(_binary(torch.maximum, np.maximum))
    minimum = staticmethod(_binary(torch.minimum, np.minimum))
    power = staticmethod(_binary(torch.pow, np.power))
    asarray = staticmethod(_asarray)

    def __getattr__(self, name):
        if _lane.get() is not None:
            raise AttributeError(
                f"jnp.{name} is not in the UDF body namespace of the "
                f"device lane")
        try:
            return getattr(np, name)
        except AttributeError:
            raise AttributeError(
                f"jnp.{name} is not in the UDF body namespace") from None


JNP = _Jnp()
NAMES = ("clip", "where", "abs", "sqrt", "exp", "log", "log1p", "floor",
         "ceil", "round", "sign", "maximum", "minimum", "power", "isnan",
         "asarray")


def compile_body(name: str, body: str) -> Callable:
    """eval the function body in a restricted namespace.  The DDL surface
    is admin-gated (same as EXEC PYTHON); the restriction keeps honest
    functions honest, it is not a sandbox."""
    ns = {"jnp": JNP, "np": np, "math": math, "torch": torch,
          "__builtins__": {"abs": abs, "min": min, "max": max, "len": len,
                           "float": float, "int": int, "round": round}}
    try:
        fn = eval(body, ns)  # noqa: S307 — gated DDL surface
    except Exception as e:
        raise ValueError(f"CREATE FUNCTION {name}: body does not "
                         f"evaluate ({e})")
    if not callable(fn):
        raise ValueError(f"CREATE FUNCTION {name}: body must evaluate "
                         f"to a callable (e.g. a lambda)")
    return fn


def register(catalog, name: str, body: str,
             returns: Optional[T.DataType]) -> UdfDef:
    if not hasattr(catalog, "_functions"):
        catalog._functions = {}
    from snappydata_tpu_torch.sql import ast

    low = name.lower()
    if low in ast.AGG_FUNCS:
        raise ValueError(f"cannot redefine aggregate function {name}")
    d = UdfDef(low, body, returns, compile_body(name, body))
    catalog._functions[low] = d
    catalog.generation += 1   # cached plans baked the old body
    return d


def unregister(catalog, name: str, if_exists: bool) -> bool:
    reg = getattr(catalog, "_functions", {})
    if name.lower() not in reg:
        if if_exists:
            return False
        raise ValueError(f"function not found: {name}")
    del reg[name.lower()]
    catalog.generation += 1
    return True
