"""Device mesh execution over shard SLOTS: shard stacked column batches,
run the partial program per slot, merge the partials.

Port of snappydata_tpu/parallel/mesh.py.  The reference lays the stacked
[num_batches, capacity] column arrays across a `jax.sharding.Mesh` along
the batch axis and lets GSPMD insert the collectives.  Torch has no such
compiler, so the port's mesh is an ordered list of *slots*: each slot has
a global index, a `torch.device` and the rank of the process that owns it.

- The slots follow the device their caller asks for (`device=`; by
  default the statement's device inside a session scope, else the cards
  where there are any, else the CPU): for `cuda` a process on a machine
  with k cards has k slots, `cuda:0 .. cuda:k-1`; for `cpu` every slot
  is `cpu`.  A session re-homes the mesh it is given onto its own device
  (`Mesh.on`), so a CPU session never binds on a card.  The `mesh_slots`
  property (env `SNAPPY_MESH_SLOTS`) asks for more slots than devices:
  slot i then sits on device `i % k` — the counterpart of the reference
  tests' `--xla_force_host_platform_device_count`.
- A mesh bind pads the batch axis to `shard_bucket(B, n)` and gives slot i
  the contiguous block of batches `[i * B/n, (i + 1) * B/n)`.  The plate
  stays ONE tensor on the mesh's home device (slot 0's); a slot on the
  home device reads its block as a leading-axis view (no copy).  A slot
  on another card reads a copy of its block made there once, when the
  plate is bound (`place_remote_blocks`), so no query copies a plate
  between cards; the home card still holds the whole plate (ROADMAP §C).
- The per-slot partial lane and its merges live in engine/mesh_exec.py;
  a query the lane declines runs the single-device program over the
  whole plates on the home device (the counterpart of "plain GSPMD jit").

After `parallel.multihost.initialize_multihost` the global slot list is
world size x local slots, rank-major; `local_device_indices()` gives
this process's, and only local slots can execute here.

The fences of the reference stay: `dispatch_lock` (a declared leaf),
`eager_fence`, `prefetch_fence`, the per-thread `MeshContext` stack and
`no_mesh`.  Torch has no collective rendezvous to deadlock, but the
fences keep multi-slot dispatches of concurrent statements serialized as
the reference's are, and the `mesh.dispatch` failpoint fires at their
entry.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from snappydata_tpu_torch.utils import locks


@dataclasses.dataclass(frozen=True)
class Slot:
    """One shard slot: its global index, its device (None for a slot of
    another process) and the rank of the process that owns it."""

    index: int
    device: Optional[torch.device]
    process: int = 0

    def __str__(self) -> str:
        return f"slot{self.index}:{self.device}"


def _default_device() -> torch.device:
    """The device of a mesh that names none: the statement's inside a
    session scope, else the cards where there are any, else the CPU."""
    from snappydata_tpu_torch import config

    dev = config.current_device()
    if dev is not None:
        return torch.device(dev)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _local_devices(device=None) -> List[torch.device]:
    """This process's devices of `device`'s type: its cards for cuda,
    the CPU for cpu."""
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def local_slot_count(device=None) -> int:
    """Slots of this process: the `mesh_slots` property, else one per
    device of `device`'s type (one on the CPU)."""
    from snappydata_tpu_torch import config

    n = int(config.global_properties().get("mesh_slots", 0) or 0)
    return n if n > 0 else len(_local_devices(device))


def local_slots(device=None) -> List[Slot]:
    from snappydata_tpu_torch.parallel import multihost

    devs = _local_devices(device)
    n = local_slot_count(device)
    rank = multihost.process_index()
    return [Slot(rank * n + i, devs[i % len(devs)], rank) for i in range(n)]


def slots(device=None) -> List[Slot]:
    """The global slot list on devices of `device`'s type: every
    process's local slots, rank-major."""
    from snappydata_tpu_torch.parallel import multihost

    mine = local_slots(device)
    world = multihost.process_count()
    if world <= 1:
        return mine
    n = len(mine)
    rank = multihost.process_index()
    out: List[Slot] = []
    for p in range(world):
        if p == rank:
            out.extend(mine)
        else:
            out.extend(Slot(p * n + i, None, p) for i in range(n))
    return out


class Mesh:
    """An ordered set of slots with one axis, "data" (the batch axis).
    `devices` is the slot array, as the reference's `Mesh.devices` is its
    device array (`.size`, `.ravel()`)."""

    def __init__(self, slot_list: Sequence[Slot]):
        self.slots = tuple(slot_list)
        if not self.slots:
            raise ValueError("a mesh needs at least one slot")
        self.devices = np.empty(len(self.slots), dtype=object)
        for i, s in enumerate(self.slots):
            self.devices[i] = s

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def home(self) -> torch.device:
        """Slot 0's device: where the plates live and the partials merge."""
        dev = self.slots[0].device
        if dev is None:
            raise ValueError(f"{self.slots[0]} belongs to process "
                             f"{self.slots[0].process}, not this one")
        return dev

    def on(self, device) -> "Mesh":
        """This mesh's slots on devices of `device`'s type: itself when
        every local slot is already there, else the same slot indices
        rebuilt there (a CPU session given a mesh of cards)."""
        typ = torch.device(device).type
        if all(s.device is None or s.device.type == typ
               for s in self.slots):
            return self
        return submesh([s.index for s in self.slots], device)

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(str(s) for s in self.slots) + ")"


class MeshContext:
    """Process-wide data mesh. When active, device tables bind with their
    batch axis split over the slots and tilable aggregates run their
    partial program once per slot (engine/mesh_exec.py).

    Each context carries a process-unique `token` (monotonic counter) used
    by device caches instead of id(mesh) — ids get reused after GC, which
    would let a 4-slot run hit plates placed for a dead 8-slot mesh.

    `placement` is the bucket->slot map (parallel/placement.py): the batch
    axis splits into logical buckets owned by slots, so a mesh resize is a
    bucket REBALANCE (storage/device.migrate_mesh_cache re-slices the
    resident plates) instead of a cache invalidation."""

    # the active-context stack is PER-THREAD (a contextvar): concurrent
    # sessions each enter their own context, and a class-global stack
    # would let thread A's __exit__ pop thread B's context mid-query
    _ctx_stack: "object" = None   # initialized below (contextvar)
    _lock = locks.named_lock("parallel.mesh")
    _next_token = 0

    def __init__(self, mesh: Mesh, placement=None):
        from snappydata_tpu_torch.parallel.placement import ShardPlacement

        self.mesh = mesh
        self.placement = placement if placement is not None \
            else ShardPlacement.balanced(mesh.size)
        with MeshContext._lock:
            MeshContext._next_token += 1
            self.token = MeshContext._next_token

    @property
    def num_devices(self) -> int:
        """Slots of the mesh (the reference's device count)."""
        return self.mesh.size

    @property
    def home(self) -> torch.device:
        return self.mesh.home

    @property
    def spans_cards(self) -> bool:
        """Whether a local slot sits off the home device."""
        home = self.home
        return any(s.device is not None and s.device != home
                   for s in self.mesh.slots)

    def home_for(self, device) -> torch.device:
        """The home device of a statement running on `device`: the
        mesh's, which must be of the statement's type (a CPU session's
        plates never land on a card)."""
        home = self.home
        if device is not None and torch.device(device).type != home.type:
            raise ValueError(
                f"the active mesh's slots sit on {home.type}, the "
                f"statement runs on {torch.device(device).type}: build "
                f"the mesh with data_mesh(n, device=...)")
        return home

    def block(self, t, i: int, batches: Optional[int] = None):
        """Slot i's block of a [B, ...]-leading tensor (or a plate
        NamedTuple / tuple of them): a leading-axis view on the home
        device, on another card the copy the bind made there.  `batches` is the padded B of the
        bind (the leaves' leading size)."""
        if t is None:
            return None
        if isinstance(t, tuple):
            parts = [self.block(x, i, batches) for x in t]
            return type(t)(*parts) if hasattr(t, "_fields") \
                else tuple(parts)
        b = int(t.shape[0]) if batches is None else int(batches)
        per = b // self.num_devices
        view = t[i * per:(i + 1) * per]
        dev = self.mesh.slots[i].device
        if dev is None:
            raise ValueError(f"{self.mesh.slots[i]} is not local")
        if view.device == dev:
            return view
        copy = remote_block(t, i * per, (i + 1) * per, dev)
        if copy is not None:
            return copy
        # a plate the bind did not place (a batch-skipping gather): its
        # block crosses cards in this query, counted without a lock (the
        # slots run under the leaf dispatch_lock; the lane reports the
        # count as `mesh_block_copies` after it)
        global _block_copies
        _block_copies += 1
        return view.to(dev)

    def shards(self, t) -> list:
        """[(slot, block)] of a batch-sharded tensor: the port's answer to
        the reference's `array.sharding.device_set`."""
        return [(s, self.block(t, i)) for i, s in enumerate(self.mesh.slots)]

    @classmethod
    def current(cls) -> Optional["MeshContext"]:
        stack = cls._ctx_stack.get()
        return stack[-1] if stack else None

    def __enter__(self):
        # plain push/pop on the per-thread stack VALUE (no contextvar
        # tokens: one shared context object entered by many threads
        # would mix tokens across threads)
        MeshContext._ctx_stack.set(MeshContext._ctx_stack.get() + (self,))
        return self

    def __exit__(self, *exc):
        stack = MeshContext._ctx_stack.get()
        if stack and stack[-1] is self:
            MeshContext._ctx_stack.set(stack[:-1])
        return False


MeshContext._ctx_stack = contextvars.ContextVar("mesh_ctx_stack",
                                                default=())

# Copies of slot blocks on the slots' own cards, made once when a plate is
# bound under a mesh whose slots span cards (`place_remote_blocks`):
# (plate layout, block range, card) -> (weakref to the plate, copy).  The
# weakref's callback drops the copy with the plate, so an evicted or
# pruned cache entry frees its copies too.  Plain dict operations (atomic
# under the GIL): no lock, so a bind inside a fence acquires nothing.
_remote_blocks: dict = {}
_block_copies = 0


def block_copies() -> int:
    """Slot blocks copied between cards at execution so far."""
    return _block_copies


def _block_key(t, start: int, stop: int, dev) -> tuple:
    return (t.data_ptr(), t.dtype, tuple(t.shape), tuple(t.stride()),
            start, stop, str(dev))


def remote_block(t, start: int, stop: int, dev):
    """The copy of `t[start:stop]` on `dev` made at bind time, or None."""
    if not _remote_blocks:
        return None
    hit = _remote_blocks.get(_block_key(t, start, stop, dev))
    return hit[1] if hit is not None and hit[0]() is not None else None


def place_remote_blocks(t, mesh: Mesh) -> int:
    """Copy each slot's block of the bound [B, ...] plate `t` to the
    slot's card, for every slot not on the home device, unless already
    there; the copies of `t` an earlier mesh (before a resize) placed go.
    Returns the bytes copied."""
    home = mesh.home
    per = int(t.shape[0]) // mesh.size
    want = {_block_key(t, i * per, (i + 1) * per, s.device)
            for i, s in enumerate(mesh.slots)
            if s.device is not None and s.device != home}
    layout = _block_key(t, 0, 0, None)[:4]
    for key in [k for k in list(_remote_blocks)
                if k[:4] == layout and k not in want]:
        _remote_blocks.pop(key, None)
    copied = 0
    for i, s in enumerate(mesh.slots):
        if s.device is None or s.device == home:
            continue
        lo, hi = i * per, (i + 1) * per
        if remote_block(t, lo, hi, s.device) is None:
            copy = _keep(t, lo, hi, s.device)
            copied += copy.numel() * copy.element_size()
    return copied


def _keep(t, lo: int, hi: int, dev):
    key = _block_key(t, lo, hi, dev)
    copy = t[lo:hi].to(dev)
    _remote_blocks[key] = (
        weakref.ref(t, lambda _r, key=key: _remote_blocks.pop(key, None)),
        copy)
    return copy


def remote_copy(t, dev):
    """`t` whole on card `dev`: one copy, kept while `t` lives (a join's
    cached build artifact crosses to a slot's card once, not per query)."""
    if t.device == dev:
        return t
    n = int(t.shape[0]) if t.dim() else 0
    hit = remote_block(t, 0, n, dev)
    return hit if hit is not None else _keep(t, 0, n, dev) if t.dim() \
        else t.to(dev)


def remote_blocks_of(t) -> list:
    """The bind-time block copies of plate `t` on other cards."""
    if not _remote_blocks:
        return []
    return [c for r, c in list(_remote_blocks.values()) if r() is t]

# Process-wide serialization of MULTI-SLOT dispatches.  The reference
# needs it because XLA's CPU collectives rendezvous by (global devices, op
# id) and two threads' 8-participant programs deadlock when interleaved;
# the port has no rendezvous, but keeps the same discipline so concurrent
# statements on one mesh dispatch their slot programs one statement at a
# time, as the reference's do.  Every sharded dispatch — the per-slot
# lane, the single-device program under a mesh, the shuffle exchange —
# holds this RLock across dispatch and completion; single-device
# execution never touches it.  Reentrant: a mesh query's host-side
# finalize may nest another sharded read.  Eager bind-time work on
# sharded plates (the join artifact's sort and expansion bounds,
# ops/join.py) fences through `eager_fence()`, and the tile prefetcher's
# background uploads through `prefetch_fence()`.  A declared LEAF of the
# lock hierarchy (tools/locklint/lock_order.toml).
dispatch_lock = locks.named_rlock("parallel.mesh_dispatch")

# set inside a prefetch worker (storage/prefetch.py): makes shard_batches
# wrap its upload in dispatch_lock — the ONLY fenced instruction of the
# background upload
_prefetch_fencing = contextvars.ContextVar("mesh_prefetch_fencing",
                                           default=False)


@contextlib.contextmanager
def prefetch_fence():
    """Mark this thread's placements as background prefetch uploads:
    every `shard_batches` upload inside runs under dispatch_lock."""
    tok = _prefetch_fencing.set(True)
    try:
        yield
    finally:
        _prefetch_fencing.reset(tok)


@contextlib.contextmanager
def eager_fence():
    """Fence a region of EAGER work on sharded plates (bind-time sorts,
    searchsorteds, host reads) exactly like a dispatch.  No-op outside a
    mesh.  The region must acquire NOTHING: dispatch_lock is a declared
    leaf, so cache stores and metric increments stay outside."""
    if MeshContext.current() is None:
        yield
        return
    # mesh_dispatch ENTRY seam — fired BEFORE acquiring the leaf lock: a
    # sleep widens the dispatch-interleave window a storm schedule
    # probes, a raise fails the statement before any slot runs
    from snappydata_tpu_torch.reliability import failpoints as rfail

    rfail.hit("mesh.dispatch")
    with dispatch_lock:
        yield


@contextlib.contextmanager
def dispatch_scope(device: Optional[torch.device] = None):
    """Hold dispatch_lock across a dispatch and its completion under an
    active mesh (the reference's `_run_device` fence); a no-op outside a
    mesh."""
    if MeshContext.current() is None:
        yield
        return
    with dispatch_lock:
        yield
        if device is not None and device.type == "cuda":
            # locklint: blocking-under-lock the dispatch lock exists
            # exactly to fence device work; the run completes inside it
            torch.cuda.synchronize(device)


class _NoMesh:
    """Escape hatch: `with no_mesh():` masks any ambient MeshContext —
    used by the mesh lane's scratch finalize so a [G]-row merge table
    never binds sharded over the slots."""

    def __enter__(self):
        MeshContext._ctx_stack.set(MeshContext._ctx_stack.get() + (None,))
        return self

    def __exit__(self, *exc):
        stack = MeshContext._ctx_stack.get()
        if stack and stack[-1] is None:
            MeshContext._ctx_stack.set(stack[:-1])
        return False


def no_mesh() -> _NoMesh:
    return _NoMesh()


def data_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """Mesh over the first `num_devices` global slots (all by default)
    on devices of `device`'s type."""
    every = slots(device)
    n = num_devices or len(every)
    if n > len(every):
        raise ValueError(f"data_mesh({n}): only {len(every)} slots (set "
                         f"the mesh_slots property for more)")
    return Mesh(every[:n])


def submesh(device_indices, device=None) -> Mesh:
    """Mesh over an explicit slot subset on devices of `device`'s type
    — the composed topology's per-server plane (each ServerNode owns a
    disjoint slice of the host's slots; ref: one embedded executor per
    store JVM)."""
    every = slots(device)
    return Mesh([every[i] for i in device_indices])


def shard_batches(array, ctx: Optional[MeshContext], device=None):
    """Place a stacked [B, C] host array for a bind: on the mesh's home
    device under a mesh (slot blocks are views of it), on `device`
    otherwise.  B is padded to a multiple of the slot count by the device
    builder."""
    from snappydata_tpu_torch.storage import device_decode as _dd

    if ctx is None:
        return _dd.upload(array, device)
    if _prefetch_fencing.get():
        # background prefetch upload: fenced like every other dispatch
        with dispatch_lock:
            return _dd.upload(array, ctx.home)
    return _dd.upload(array, ctx.home)


def round_up_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def shard_bucket(n: int, num_shards: int) -> int:
    """Padded batch-axis size for a MESH bind: the smallest value of the
    storage layer's {2^k, 1.5*2^k} batch-bucket ladder that is >= n AND
    divisible by `num_shards` (equal blocks per slot), so a table bound at
    1/2/4/8 slots lands on the padded sizes the single-device ladder
    already produced.  Shard counts the ladder never divides (e.g. 5)
    fall back to the nearest multiple."""
    n = max(1, n, num_shards)
    v = _ladder(n)
    # the ladder doubles every two steps; 8 steps ~ 16x headroom, far
    # past any divisible hit for pow2 / 3*pow2 shard counts
    for _ in range(8):
        if v % num_shards == 0:
            return v
        v = _ladder(v + 1)
    return round_up_to(_ladder(n), num_shards)


def _ladder(n: int) -> int:
    """Smallest {2^k, 1.5*2^k} >= n (storage/device.batch_bucket's ladder,
    duplicated here to avoid a parallel -> storage import cycle; the unit
    test pins the two against each other)."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    return p * 3 // 4 if p * 3 // 4 >= n else p
