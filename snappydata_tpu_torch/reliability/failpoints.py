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
  corrupt_bytes  data plane: ``mangle()`` XOR-flips ``param`` bytes of
                 the buffer at a seeded offset (CRC-detectable damage)
  short_write    data plane: ``mangle()`` cuts ``param`` bytes off the
                 buffer's tail, and the write site sees the short count

  latency        sleep ``param`` seconds, then continue
  drop           raise FaultConnectionDropped (a ConnectionError: the
                 failover paths treat it like a lost peer)

``count=N`` fires the first N eligible hits then lies dormant;
``prob=X`` fires on a fraction X of hits, off the registry RNG, which is
seeded (``reseed()``, ``SNAPPY_FAILPOINT_SEED``, ``SNAPPY_TPU_FAULT_SEED``
or the ``fault_seed`` property) so a fault schedule replays exactly;
``every=N`` fires every Nth eligible hit.  No trigger fires every hit.
``phase`` (before | after) picks the side of the guarded operation a
``hit(name, phase)`` call sits on.

Arming is per test (``arm()`` / ``clear()``) or from a spec string
(``arm_from_spec``) in either of the reference's grammars::

    name=action[(param)][:count|:prob][;...]              (SNAPPY_FAILPOINTS)
    name=action[:param][@N|@eN|@pX][!exc][#after][;...]   (SNAPPY_TPU_FAULTS)

or a JSON list of spec objects.  An entry holding ``@``, ``!`` or
``#after`` reads the second way, any other the first.  The two
environment variables and the ``faults`` property are read once, when
this module is imported.

The seams wired in the port (grep ``failpoints.hit`` / ``mangle``) are
KNOWN_POINTS: wal.append (per record), wal.group_commit (per group, at
the batched write), wal.fsync, wal.salvage, checkpoint.write,
checkpoint.publish, storage.compaction, the disk tier's tier.demote,
tier.write (hit and mangle), tier.promote and tier.memmap_read,
broker.admit, prefetch.worker, the Flight front door's flight.rpc,
flight.serve, flight.send and flight.recv, kafka.fetch, the member's
locator.heartbeat and mesh.dispatch (at the entry of a multi-slot
dispatch fence, before its lock).  Arming other names is allowed.  A
data-plane spec never fires at ``hit()``, and a control-plane spec never
at ``mangle()``.

Zero cost when unarmed: ``hit()`` and ``mangle()`` check one
module-global dict for truthiness and return before touching any lock,
metric or the RNG.

Every fired action bumps ``fault_injected`` and
``fault_injected_<name>``; ``fired_counts()`` gives the same accounting
programmatically.

Lock: ``reliability.failpoints`` is a leaf: hit() runs inside deep lock
stacks (the WAL drain under wal_io) and acquires nothing else.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import json
import os
import random
import time
from typing import Dict, List, Optional, Union

import numpy as np

from snappydata_tpu_torch.utils import locks


class InjectedFault(IOError):
    """Default exception of the `raise` action, and the crash half of
    `torn_write`: IO-shaped, like a real unclassified disk error."""


class WorkerKilled(RuntimeError):
    """The kill_worker action: background-worker bodies let it escape
    their loop, like an uncaught real death."""


class FaultConnectionDropped(ConnectionError):
    """Injected connection loss (action `drop`, exc family `conn`)."""


_EXC_FAMILIES = {
    "io": InjectedFault,
    "runtime": RuntimeError,
    "timeout": TimeoutError,
    "oserror": OSError,
    "conn": FaultConnectionDropped,
}

ACTIONS = ("raise", "sleep", "kill_worker", "return_errno", "torn_write",
           "corrupt_bytes", "short_write", "latency", "drop")

# canonical points wired into the port (module docstring) — arming other
# names is allowed, so this is documentation the tests hold to the code
KNOWN_POINTS = (
    "wal.append", "wal.group_commit", "wal.fsync", "wal.salvage",
    "checkpoint.write", "checkpoint.publish", "storage.compaction",
    "tier.demote", "tier.write", "tier.promote", "tier.memmap_read",
    "broker.admit", "prefetch.worker", "flight.rpc", "flight.serve",
    "flight.send", "flight.recv", "kafka.fetch", "locator.heartbeat",
    "mesh.dispatch",
)

# data-plane actions are interpreted by mangle(); hit() passes them by
_DATA_ACTIONS = ("corrupt_bytes", "short_write")


@dataclasses.dataclass
class FailSpec:
    name: str
    action: str
    param: float = 0.0            # ms / bytes / errno by action
    exc: Union[str, type, None] = None
    count: Optional[int] = None   # fire at most N times
    prob: Optional[float] = None  # fire with probability (seeded RNG)
    every: Optional[int] = None   # fire on every Nth eligible hit
    phase: str = "before"         # before | after the guarded operation
    hits: int = 0
    fired: int = 0

    def to_dict(self) -> dict:
        exc = self.exc.__name__ if isinstance(self.exc, type) else self.exc
        d = {"name": self.name, "action": self.action,
             "param": self.param, "exc": exc, "count": self.count,
             "prob": self.prob, "every": self.every, "phase": self.phase,
             "hits": self.hits, "fired": self.fired}
        return {k: v for k, v in d.items() if v is not None}


# name -> [FailSpec]; the module global IS the zero-cost gate: hit()
# returns on `if not _SPECS` before any lock
_SPECS: Dict[str, List[FailSpec]] = {}
_LOCK = locks.named_rlock("reliability.failpoints")


def _props():
    from snappydata_tpu_torch import config

    return config.global_properties()


def _initial_seed() -> int:
    for var in ("SNAPPY_FAILPOINT_SEED", "SNAPPY_TPU_FAULT_SEED"):
        v = int(os.environ.get(var, "0") or 0)
        if v:
            return v
    return int(_props().get("fault_seed") or 0)


_RNG = random.Random(_initial_seed())


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
        prob: Optional[float] = None, every: Optional[int] = None,
        phase: str = "before", p: Optional[float] = None) -> FailSpec:
    """Arm one spec (`p` is the fault grammar's name for `prob`)."""
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}; "
                         f"one of {ACTIONS}")
    if isinstance(exc, str) and exc.lower() not in _EXC_FAMILIES:
        raise ValueError(f"unknown exc family {exc!r}; "
                         f"one of {tuple(_EXC_FAMILIES)}")
    if phase not in ("before", "after"):
        raise ValueError("phase must be 'before' or 'after'")
    if action == "torn_write" and phase == "after":
        # no site interprets a torn write after its operation: arming one
        # would never fire and give a schedule false coverage
        raise ValueError("torn_write only supports phase='before'")
    if action == "return_errno" and not param:
        param = float(_errno.EIO)
    spec = FailSpec(name, action, float(param), exc, count,
                    prob if prob is not None else p, every, phase)
    with _LOCK:
        _SPECS.setdefault(name, []).append(spec)
    return spec


def arm_from_spec(text: str, grammar: Optional[str] = None
                  ) -> List[FailSpec]:
    """Arm from a spec string (module docstring): a JSON list (or one
    object) of `arm` keyword sets, or `;`-separated compact entries.
    `grammar` "fault" reads every compact entry the SNAPPY_TPU_FAULTS
    way; by default each entry picks its grammar by its markers."""
    text = text.strip()
    if text.startswith(("[", "{")):
        items = json.loads(text)
        if isinstance(items, dict):
            items = [items]
        return [arm(**it) for it in items]
    out: List[FailSpec] = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rest = entry.partition("=")
        if not sep or not rest:
            raise ValueError(f"bad failpoint entry {entry!r}: expected "
                             f"name=action...")
        if grammar == "fault" or any(m in rest for m in ("@", "!", "#")):
            out.append(_arm_fault_entry(name.strip(), rest))
        else:
            out.append(_arm_compact_entry(name.strip(), rest))
    return out


def _arm_compact_entry(name: str, rest: str) -> FailSpec:
    """``action[(param)][:count|:prob]``: ``tier.write=corrupt_bytes(3):1``
    flips 3 bytes once, ``wal.fsync=sleep(5):0.1`` sleeps 5 ms on 10% of
    hits (seeded), ``broker.admit=raise`` fires every hit."""
    count = prob = None
    action, _, trig = rest.partition(":")
    if trig:
        t = float(trig)
        if t < 1.0 and "." in trig:
            prob = t
        else:
            count = int(t)
    param = 0.0
    if action.endswith(")") and "(" in action:
        action, _, pv = action[:-1].partition("(")
        param = float(pv) if pv else 0.0
    return arm(name, action.strip(), param=param, count=count, prob=prob)


def _arm_fault_entry(name: str, rest: str) -> FailSpec:
    """``action[:param][@trigger][!exc][#after]``: trigger N is a count,
    eN every Nth hit, pX a probability."""
    phase = "before"
    if rest.endswith("#after"):
        phase, rest = "after", rest[:-len("#after")]
    exc = "io"
    if "!" in rest:
        rest, _, exc = rest.partition("!")
    count = every = prob = None
    if "@" in rest:
        rest, _, trig = rest.partition("@")
        if trig.startswith("p"):
            prob = float(trig[1:])
        elif trig.startswith("e"):
            every = int(trig[1:])
        else:
            count = int(trig)
    action, _, param = rest.partition(":")
    return arm(name, action.strip(), param=float(param) if param else 0.0,
               exc=exc, count=count, prob=prob, every=every, phase=phase)


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


def snapshot() -> List[dict]:
    """Every armed spec with its hits and fires (the storage status
    page's failpoint list)."""
    with _LOCK:
        return [sp.to_dict() for specs in _SPECS.values() for sp in specs]


def fired_counts() -> Dict[str, int]:
    """name -> times an armed action actually ran."""
    with _LOCK:
        return {nm: sum(s.fired for s in specs)
                for nm, specs in _SPECS.items()
                if any(s.fired for s in specs)}


# -- the hooks -------------------------------------------------------------

def _account(name: str) -> None:
    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    reg.inc("fault_injected")
    reg.inc(f"fault_injected_{name.replace('.', '_')}")


def _select(name: str, data_plane: bool = False,
            phase: str = "before") -> Optional[FailSpec]:
    with _LOCK:
        for spec in _SPECS.get(name, ()):
            if (spec.action in _DATA_ACTIONS) != data_plane \
                    or spec.phase != phase:
                continue
            if spec.count is not None and spec.fired >= spec.count:
                continue
            spec.hits += 1
            if spec.prob is not None and _RNG.random() >= spec.prob:
                continue
            if spec.every is not None and spec.hits % spec.every:
                continue
            spec.fired += 1
            return spec
    return None


def hit(name: str, phase: str = "before") -> Optional[FailSpec]:
    """The hook production code calls at a seam.  Unarmed: one falsy-dict
    check, nothing else.  Armed: raise / sleep / kill per the triggering
    spec; a `torn_write` spec is returned for the site to apply."""
    if not _SPECS:               # hot-path gate: no lock, no call
        return None
    spec = _select(name, phase=phase)
    if spec is None:
        return None
    _account(name)
    if spec.action == "torn_write":
        return spec
    if spec.action == "sleep":
        time.sleep(spec.param / 1000.0)
        return None
    if spec.action == "latency":
        time.sleep(spec.param)
        return None
    if spec.action == "drop":
        raise FaultConnectionDropped(
            f"failpoint {name}: injected connection drop")
    if spec.action == "kill_worker":
        raise WorkerKilled(f"failpoint {name}: injected worker death")
    if spec.action == "return_errno":
        e = int(spec.param) or _errno.EIO
        raise OSError(e, f"failpoint {name}: injected "
                         f"{_errno.errorcode.get(e, e)}")
    raise _resolve_exc(spec)(f"failpoint {name}: injected failure")


def mangle(name: str, buf: bytes) -> bytes:
    """The data-plane hook: a write site passes the exact bytes about to
    land on disk; an armed corrupt_bytes / short_write spec returns a
    damaged copy (seeded offsets: deterministic), anything else returns
    `buf` untouched."""
    if not _SPECS:               # hot-path gate, mirror of hit()
        return buf
    spec = _select(name, data_plane=True)
    if spec is None:
        return buf
    _account(name)
    n = max(1, int(spec.param))
    if spec.action == "short_write":
        return buf[:max(0, len(buf) - n)]
    # corrupt_bytes: XOR-flip n bytes at a seeded offset past the first
    # 8 bytes, so magic and head length stay readable and the damage is
    # caught by the CRC (the quarantine path), not fatal to the frame
    arr = np.frombuffer(buf, dtype=np.uint8).copy()
    lo = 8 if len(arr) > 8 + n else 0
    with _LOCK:
        off = _RNG.randrange(lo, max(lo + 1, len(arr) - n))
    arr[off:off + n] ^= 0xFF
    return arr.tobytes()


def _arm_env() -> None:
    """Boot-time arming: SNAPPY_FAILPOINTS, then SNAPPY_TPU_FAULTS and
    the `faults` property (the second grammar)."""
    env = os.environ.get("SNAPPY_FAILPOINTS")
    if env:
        arm_from_spec(env)
    env = os.environ.get("SNAPPY_TPU_FAULTS")
    if env:
        arm_from_spec(env, grammar="fault")
    conf = str(_props().get("faults") or "")
    if conf:
        arm_from_spec(conf, grammar="fault")


_arm_env()
