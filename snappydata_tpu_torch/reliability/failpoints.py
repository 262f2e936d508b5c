"""Named-failpoint registry with deterministic seeded triggers: the
storage fault-injection plane (port of the reference's two registries,
snappydata_tpu/reliability/failpoints.py and fault/failpoints.py, as one).

Production code calls ``hit(name)`` at a seam; a spec armed under that
name decides what the next eligible hits do:

  raise          raise an exception (``exc``: a class, or a family name
                 from _EXC_FAMILIES; default InjectedFault, an IOError)
  sleep          sleep ``param`` milliseconds, then continue
  kill_worker    raise WorkerKilled: background-worker bodies let it
                 escape so their supervision engages
  return_errno   raise OSError(param): param is the errno (default EIO)
  torn_write     ``hit`` returns the spec and the write site cuts
                 ``param`` bytes off what it writes, then raises
                 InjectedFault: the crash-mid-write shape

``count=N`` fires the first N eligible hits then lies dormant;
``prob=X`` fires on a fraction X of hits, off the registry RNG, which is
seeded (``reseed()``) so a fault schedule replays exactly.  No trigger
fires every hit.

The seams wired in the port (grep ``failpoints.hit``): wal.append (per
record), wal.group_commit (per group, at the batched write), wal.fsync,
wal.salvage, checkpoint.write, checkpoint.publish and
storage.compaction.  Arming other names is allowed.

Zero cost when unarmed: ``hit()`` checks one module-global dict for
truthiness and returns before touching any lock, metric or the RNG.

Every fired action bumps ``fault_injected`` and
``fault_injected_<name>``; ``fired_counts()`` gives the same accounting
programmatically.

Lock: ``reliability.failpoints`` is a leaf: hit() runs inside deep lock
stacks (the WAL drain under wal_io) and acquires nothing else.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import random
import time
from typing import Dict, List, Optional, Union

from snappydata_tpu_torch.utils import locks


class InjectedFault(IOError):
    """Default exception of the `raise` action, and the crash half of
    `torn_write`: IO-shaped, like a real unclassified disk error."""


class WorkerKilled(RuntimeError):
    """The kill_worker action: background-worker bodies let it escape
    their loop, like an uncaught real death."""


_EXC_FAMILIES = {
    "io": InjectedFault,
    "runtime": RuntimeError,
    "timeout": TimeoutError,
    "oserror": OSError,
}

ACTIONS = ("raise", "sleep", "kill_worker", "return_errno", "torn_write")


@dataclasses.dataclass
class FailSpec:
    name: str
    action: str
    param: float = 0.0            # ms / bytes / errno by action
    exc: Union[str, type, None] = None
    count: Optional[int] = None   # fire at most N times
    prob: Optional[float] = None  # fire with probability (seeded RNG)
    hits: int = 0
    fired: int = 0


# name -> [FailSpec]; the module global IS the zero-cost gate: hit()
# returns on `if not _SPECS` before any lock
_SPECS: Dict[str, List[FailSpec]] = {}
_LOCK = locks.named_rlock("reliability.failpoints")
_RNG = random.Random(0)


def _resolve_exc(spec: FailSpec):
    exc = spec.exc
    if exc is None:
        return InjectedFault
    if isinstance(exc, type):
        return exc
    return _EXC_FAMILIES.get(str(exc).lower(), InjectedFault)


# -- arming ----------------------------------------------------------------

def arm(name: str, action: str, param: float = 0.0,
        exc: Union[str, type, None] = None, count: Optional[int] = None,
        prob: Optional[float] = None) -> FailSpec:
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}; "
                         f"one of {ACTIONS}")
    if isinstance(exc, str) and exc.lower() not in _EXC_FAMILIES:
        raise ValueError(f"unknown exc family {exc!r}; "
                         f"one of {tuple(_EXC_FAMILIES)}")
    if action == "return_errno" and not param:
        param = float(_errno.EIO)
    spec = FailSpec(name, action, float(param), exc, count, prob)
    with _LOCK:
        _SPECS.setdefault(name, []).append(spec)
    return spec


def disarm(name: str) -> bool:
    with _LOCK:
        return _SPECS.pop(name, None) is not None


def clear() -> None:
    with _LOCK:
        _SPECS.clear()


def reseed(seed: int) -> None:
    """Restart the trigger RNG: same seed + same hit sequence replays
    the identical fault schedule."""
    global _RNG
    with _LOCK:
        _RNG = random.Random(int(seed))


def fired_counts() -> Dict[str, int]:
    """name -> times an armed action actually ran."""
    with _LOCK:
        return {nm: sum(s.fired for s in specs)
                for nm, specs in _SPECS.items()
                if any(s.fired for s in specs)}


# -- the hook --------------------------------------------------------------

def _select(name: str) -> Optional[FailSpec]:
    with _LOCK:
        for spec in _SPECS.get(name, ()):
            if spec.count is not None and spec.fired >= spec.count:
                continue
            spec.hits += 1
            if spec.prob is not None and _RNG.random() >= spec.prob:
                continue
            spec.fired += 1
            return spec
    return None


def hit(name: str) -> Optional[FailSpec]:
    """The hook production code calls at a seam.  Unarmed: one falsy-dict
    check, nothing else.  Armed: raise / sleep / kill per the triggering
    spec; a `torn_write` spec is returned for the site to apply."""
    if not _SPECS:               # hot-path gate: no lock, no call
        return None
    spec = _select(name)
    if spec is None:
        return None
    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    reg.inc("fault_injected")
    reg.inc(f"fault_injected_{name.replace('.', '_')}")
    if spec.action == "torn_write":
        return spec
    if spec.action == "sleep":
        time.sleep(spec.param / 1000.0)
        return None
    if spec.action == "kill_worker":
        raise WorkerKilled(f"failpoint {name}: injected worker death")
    if spec.action == "return_errno":
        e = int(spec.param) or _errno.EIO
        raise OSError(e, f"failpoint {name}: injected "
                         f"{_errno.errorcode.get(e, e)}")
    raise _resolve_exc(spec)(f"failpoint {name}: injected failure")
