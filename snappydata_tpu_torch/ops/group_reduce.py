"""Fused grouped reductions in one pass: SUM / COUNT / MIN / MAX over
float32 values (`grouped_reduce`), and COUNT / SUM of decoded code-plate
products (`grouped_code_reduce`).

Replaces the TPU kernel snappydata_tpu/ops/pallas_group.py
grouped_reduce (kernel from `_make_kernel`, launched by `_grouped_call`):
the dictionary fast path of a GROUP BY (TPC-H Q1: a handful of SUM/AVG/
COUNT slots over G <= 64 groups, the executor's +1 overflow segment
included) computes every fused slot in ONE streaming pass that shares the
group-index load.  Sums keep a Kahan compensation per chain and combine
in float64 as sum(s) - sum(c); counts are exact integers; MIN/MAX start
from +/-inf, so an empty group keeps the filler the packed families
produce.

On Hopper the bound is bytes: 4 B of group index, 1 B per distinct mask
and 4 B per distinct value column per row, against a few f32 adds per
slot.  The design (csrc/group_partials.cuh, csrc/group_reduce.cu):

- `chain_plan` maps the caller's slots to the kernel's chains: slots
  with the same (kind, values, mask) by identity share one chain, and the
  chains are ordered sums first.  Both the CUDA and the CPU branch use it,
  and every caller's slot gets its result back in its own position.
- Where the TPU kept [G, 8, 128] per-lane carries in VMEM, each thread
  keeps a private column of partial words in shared memory: an (s, c)
  pair per sum, one word per other chain, so a block needs (chains +
  sums) * G * THREADS * 4 bytes.  `op_smem_bytes` is one distinct chain's
  share of it — the executor stops fusing slots before a block would need
  more than the 227 KB an SM offers, as the VMEM budget did on the TPU.
- The chain count is a compile-time bucket, so one row reads all of its
  words, updates them in registers and writes them back.
- The spec travels by value in the kernel's parameters (`_GroupSpec`,
  mirrored in ctypes): no upload per call.
- The grid is persistent: resident blocks per SM from
  cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs.  Each
  block writes one float64 per (chain, group) and one combine kernel,
  launched by the same C entry point, writes the final [chains, G] rows in
  their own types; the wrapper only takes views of them.

`grouped_code_reduce` replaces the TPU kernel
snappydata_tpu/ops/pallas_group.py grouped_code_reduce (kernel from
`_make_code_kernel`, launched by `_grouped_code_call`): the Q1 shape over
encoded batches, one shared row mask, each slot a count or the Kahan sum
of (an optional plain f32 column) x the product of code factors decoded
from per-batch dictionaries (`1 - disc`, `1 + tax` transformed on the
host).  Its kernel (csrc/group_code_reduce.cu) shares the partial layout
and the combine; identical slots share a chain through `chain_plan`; the
slot table and every pointer are one by-value struct (`_CodeSpec`); the
threads per block come from SMEM_BUDGET, down to one warp; and a
persistent grid walks (batch, chunk) tiles (`tile_range`), reloading a
batch's dictionary rows into shared memory (`dict_span` entries each)
only when its batch changes.

Each wrapper launches its kernel for CUDA tensors (counted in
`<wrapper>.launches`, its launch configuration in `<wrapper>.config`) and
runs the plain version for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from snappydata_tpu_torch.ops import cuda_build

# G cap, counting the +1 overflow segment the executor reserves for
# invalid rows (same regime as reduction.UNROLL_MAX_SEGMENTS)
MAX_GROUPS = 64
# chains of one launch (csrc/group_partials.cuh kMaxChains)
MAX_OPS = 32
THREADS = 128
# shared memory one block may use on Hopper (232,448 bytes)
SMEM_BUDGET = 227 * 1024

_KINDS = ("sum", "count", "min", "max")
# compile-time buckets: chains of the grouped kernel, sums of the code
# kernel (whose counts of the one shared mask are a single chain)
_BUCKETS = (2, 4, 8, 16, 32)
_CODE_BUCKETS = (4, 8, 16)
# steps of the plain version's chains: chains = ceil(n / _PLAIN_STEPS)
_PLAIN_STEPS = 256


def _words(kind: str) -> int:
    return 2 if kind == "sum" else 1


def op_smem_bytes(kind: str, num_segments: int) -> int:
    """Shared memory one distinct chain adds to a block of the grouped
    kernel: its per-thread, per-group words (two for a Kahan sum)."""
    return _words(kind) * num_segments * THREADS * 4


def chain_plan(keys: Sequence[Hashable],
               sums: Sequence[bool]) -> Tuple[List[int], List[int]]:
    """Map caller slots to kernel chains.  Slots with equal keys share one
    chain; chains are ordered sums first (the partial layout of
    csrc/group_partials.cuh), otherwise in first-seen order.  Returns
    (firsts, where): firsts[j] is the caller position whose slot is chain
    j, where[i] the chain whose result caller position i gets."""
    seen: Dict[Hashable, int] = {}
    distinct: List[int] = []
    for i, key in enumerate(keys):
        if key not in seen:
            seen[key] = len(distinct)
            distinct.append(i)
    order = sorted(range(len(distinct)), key=lambda j: not sums[distinct[j]])
    rank = {j: r for r, j in enumerate(order)}
    return ([distinct[j] for j in order],
            [rank[seen[key]] for key in keys])


def op_key(op) -> tuple:
    """The identity of one grouped_reduce op: (kind, values, mask) by
    object identity (a count has no values)."""
    kind, values, mask = op
    return (kind, None if kind == "count" or values is None
            else id(values), id(mask))


def _bucket(n: int, buckets: Sequence[int]) -> int:
    return next(b for b in buckets if b >= n)


class _Chains(ctypes.Structure):
    # gp::Chains
    _fields_ = [("n", ctypes.c_int), ("n_sums", ctypes.c_int),
                ("G", ctypes.c_int), ("kind", ctypes.c_int * MAX_OPS)]


class _GroupSpec(ctypes.Structure):
    # GroupSpec of csrc/group_reduce.cu
    _fields_ = [("ch", _Chains),
                ("values", ctypes.c_void_p * MAX_OPS),
                ("masks", ctypes.c_void_p * MAX_OPS)]


def _fill_chains(ch: _Chains, kinds: Sequence[str], G: int) -> int:
    """Fill the chain header; returns the words per group and thread."""
    ch.n = len(kinds)
    ch.n_sums = sum(k == "sum" for k in kinds)
    ch.G = G
    for i, k in enumerate(kinds):
        ch.kind[i] = _KINDS.index(k)
    return ch.n + ch.n_sums


def _check_ops(ops, num_segments: int) -> None:
    if not 1 <= num_segments <= MAX_GROUPS:
        raise ValueError(f"grouped_reduce: {num_segments} segments "
                         f"(1..{MAX_GROUPS})")
    if not ops:
        raise ValueError("grouped_reduce: no ops")
    for k, _v, _m in ops:
        if k not in _KINDS:
            raise ValueError(f"grouped_reduce: unknown kind {k!r}")


def grouped_reduce_plain(ops: Sequence[Tuple[str, Optional[torch.Tensor],
                                             torch.Tensor]],
                         gidx: torch.Tensor,
                         num_segments: int) -> List[torch.Tensor]:
    """Plain PyTorch version of the kernel's arithmetic: ceil(n / 256)
    chains advanced in lock step, each holding per-group Kahan partials
    (sums), exact counts and +/-inf-seeded min/max; chains combine in
    float64 / int64 at the end."""
    _check_ops(ops, num_segments)
    dev = gidx.device
    G = num_segments
    n = gidx.numel()
    chains = max(1, -(-n // _PLAIN_STEPS))
    total = _PLAIN_STEPS * chains

    def lay(a, dtype, fill):
        out = torch.full((total,), fill, dtype=dtype, device=dev)
        out[:n] = a.reshape(-1).to(dtype)
        return out.view(_PLAIN_STEPS, chains)

    g = lay(gidx, torch.int64, 0)
    laid: Dict[Tuple[int, str], torch.Tensor] = {}

    def intern(a, role, dtype, fill):
        key = (id(a), role)
        if key not in laid:
            laid[key] = lay(a, dtype, fill)
        return laid[key]

    spec = []
    for k, v, m in ops:
        mi = intern(m, "m", torch.bool, False)
        vi = None if k == "count" else intern(v, "v", torch.float32, 0.0)
        spec.append((k, vi, mi))
    zero = torch.zeros((G, chains), dtype=torch.float32, device=dev)
    state = []
    for k, _v, _m in spec:
        if k == "sum":
            state.append([zero.clone(), zero.clone()])
        elif k == "count":
            state.append([torch.zeros((G, chains), dtype=torch.int64,
                                      device=dev)])
        else:
            state.append([torch.full((G, chains),
                                     float("inf") if k == "min"
                                     else float("-inf"),
                                     dtype=torch.float32, device=dev)])
    garange = torch.arange(G, device=dev)[:, None]
    for i in range(_PLAIN_STEPS):
        gm = g[i][None, :] == garange
        sels: Dict[int, torch.Tensor] = {}
        for (k, v, m), st in zip(spec, state):
            sel = sels.get(id(m))
            if sel is None:
                sel = sels[id(m)] = gm & m[i][None, :]
            if k == "count":
                st[0] += sel
                continue
            if k == "sum":
                s, c = st
                y = torch.where(sel, v[i][None, :], 0.0) - c
                t = s + y
                st[1] = (t - s) - y
                st[0] = t
            elif k == "min":
                st[0] = torch.minimum(
                    st[0], torch.where(sel, v[i][None, :], float("inf")))
            else:
                st[0] = torch.maximum(
                    st[0], torch.where(sel, v[i][None, :], float("-inf")))
    out = []
    for (k, _v, _m), st in zip(spec, state):
        if k == "sum":
            out.append(st[0].double().sum(1) - st[1].double().sum(1))
        elif k == "count":
            out.append(st[0].sum(1))
        elif k == "min":
            out.append(st[0].amin(1))
        else:
            out.append(st[0].amax(1))
    return out


def pack_group_spec(chains, n: int, num_segments: int,
                    dev) -> Tuple[_GroupSpec, int, bool]:
    """The kernel's by-value spec for `chains` (distinct ops, sums first)
    over n rows and `num_segments` groups on `dev`: (spec, words per
    group and thread, whether the four-row loads may run).  Raises on an
    input the kernel cannot take.  The spec holds raw pointers: the
    caller keeps the tensors alive."""
    if len(chains) > MAX_OPS:
        raise ValueError(f"grouped_reduce: {len(chains)} distinct ops "
                         f"(1..{MAX_OPS})")
    spec = _GroupSpec()
    words = _fill_chains(spec.ch, [k for k, _v, _m in chains], num_segments)
    aligned = True
    for i, (k, v, m) in enumerate(chains):
        for a, role, dtype, align in ((m, "mask", torch.bool, 4),
                                      (v, "value", torch.float32, 16)):
            if role == "value" and k == "count":
                continue
            if a.dtype != dtype or a.device != dev or a.numel() != n \
                    or not a.is_contiguous():
                raise TypeError(
                    f"grouped_reduce: {role} input must be a contiguous "
                    f"{dtype} tensor with {n} elements on {dev}")
            (spec.masks if role == "mask" else spec.values)[i] = \
                a.data_ptr()
            aligned &= a.data_ptr() % align == 0
    return spec, words, aligned


def _typed_rows(out: torch.Tensor, kinds: Sequence[str],
                G: int) -> List[torch.Tensor]:
    """Views of the combine kernel's [chains, G] 8-byte cells in each
    chain's type: float64 sums, int64 counts, float32 min/max."""
    rows = []
    for j, k in enumerate(kinds):
        if k == "sum":
            rows.append(out[j])
        elif k == "count":
            rows.append(out[j].view(torch.int64))
        else:
            rows.append(out[j].view(torch.float32)[:G])
    return rows


def grouped_reduce(ops: Sequence[Tuple[str, Optional[torch.Tensor],
                                       torch.Tensor]],
                   gidx: torch.Tensor,
                   num_segments: int) -> List[torch.Tensor]:
    """Fused segmented reduction of all `ops` in one streaming pass.

    ops: (kind, values, mask) per aggregate slot — kind in
    sum/count/min/max, values a float32 tensor (None for count), mask the
    slot's validity (row valid AND value non-null).  gidx: int32 group
    index per element, < num_segments <= MAX_GROUPS.  Identical ops (same
    kind, values and mask by identity) are computed once; at most MAX_OPS
    distinct ones.  Returns one [num_segments] tensor per op: float64 for
    sums, int64 for counts, float32 (with +/-inf empty-group fillers) for
    min/max."""
    if gidx.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"grouped_reduce: no kernel for "
                           f"{gidx.device.type} tensors")
    _check_ops(ops, num_segments)
    firsts, where = chain_plan([op_key(o) for o in ops],
                               [o[0] == "sum" for o in ops])
    chains = [ops[i] for i in firsts]
    if gidx.device.type == "cpu":
        res = grouped_reduce_plain(chains, gidx, num_segments)
        return [res[j] for j in where]
    if gidx.dtype != torch.int32:
        raise TypeError(f"grouped_reduce: int32 group index, got "
                        f"{gidx.dtype}")
    dev = gidx.device
    G = num_segments
    g = gidx.reshape(-1).contiguous()
    n = g.numel()
    chains = [(k, None if v is None else v.reshape(-1), m.reshape(-1))
              for k, v, m in chains]
    spec, words, aligned = pack_group_spec(chains, n, G, dev)
    smem = words * G * THREADS * 4
    if smem > SMEM_BUDGET:
        raise ValueError(f"grouped_reduce: {smem} bytes of shared memory "
                         f"exceed the {SMEM_BUDGET}-byte budget")
    kb = _bucket(len(chains), _BUCKETS)
    # the four-row loads need 16-byte aligned index and values and 4-byte
    # aligned masks; otherwise the kernel reads row by row
    vec = aligned and g.data_ptr() % 16 == 0
    per_sm = cuda_build.blocks_per_sm("group_reduce",
                                      "group_reduce_occupancy", kb, smem)
    sms = cuda_build.sm_count(dev)
    blocks = max(1, min(-(-n // (THREADS * 4)), per_sm * sms))
    part = torch.empty((len(chains), G, blocks), dtype=torch.float64,
                       device=dev)
    out = torch.empty((len(chains), G), dtype=torch.float64, device=dev)
    rc = cuda_build.entry(*_GROUP_REDUCE)(
        g.data_ptr(), n, ctypes.byref(spec), kb, int(vec), part.data_ptr(),
        blocks, out.data_ptr(), smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "group_reduce_f32 launch")
    grouped_reduce.launches += 1
    grouped_reduce.config = {
        "threads": THREADS, "blocks": blocks, "blocks_per_sm": per_sm,
        "bucket": kb, "words": words, "smem": smem, "ops": len(ops),
        "chains": len(chains)}
    res = _typed_rows(out, [k for k, _v, _m in chains], G)
    return [res[j] for j in where]


grouped_reduce.launches = 0
grouped_reduce.config = None


# the C entry points: (source under csrc/, function, argument types)
_GROUP_REDUCE = ("group_reduce", "group_reduce_f32", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(_GroupSpec),
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])


# --- grouped reduction over code plates (the Q1 shape) ---------------------

_CODE_THREADS = (128, 64, 32)
# csrc/group_code_reduce.cu kMaxSlots, kHoist, kMaxExtra, kMaxDicts
MAX_CODE_SLOTS = 16
CODE_HOIST = 2
MAX_CODE_EXTRA = 16
MAX_CODE_DICTS = 8


class _Factor(ctypes.Structure):
    # Factor of csrc/group_code_reduce.cu
    _fields_ = [("codes", ctypes.c_void_p), ("dict", ctypes.c_void_p),
                ("code_bytes", ctypes.c_int), ("dict_w", ctypes.c_int),
                ("dict_off", ctypes.c_int), ("pad", ctypes.c_int)]


class _CodeSpec(ctypes.Structure):
    # CodeSpec of csrc/group_code_reduce.cu
    _fields_ = [("ch", _Chains),
                ("gidx", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("cap", ctypes.c_longlong), ("B", ctypes.c_int),
                ("n_dicts", ctypes.c_int),
                ("plain", ctypes.c_void_p * MAX_CODE_SLOTS),
                ("n_factors", ctypes.c_int * MAX_CODE_SLOTS),
                ("extra0", ctypes.c_int * MAX_CODE_SLOTS),
                ("factor", (_Factor * CODE_HOIST) * MAX_CODE_SLOTS),
                ("extra", _Factor * MAX_CODE_EXTRA),
                ("dicts", ctypes.c_void_p * MAX_CODE_DICTS),
                ("dict_w", ctypes.c_int * MAX_CODE_DICTS),
                ("dict_off", ctypes.c_int * MAX_CODE_DICTS)]


def _check_code_slots(slots, num_segments: int) -> None:
    if not 1 <= num_segments <= MAX_GROUPS:
        raise ValueError(f"grouped_code_reduce: {num_segments} segments "
                         f"(1..{MAX_GROUPS})")
    if not slots:
        raise ValueError("grouped_code_reduce: no slots")
    for slot in slots:
        if slot[0] not in ("count", "sum") \
                or (slot[0] == "count" and len(slot) != 1) \
                or (slot[0] == "sum" and len(slot) != 3):
            raise ValueError(f"grouped_code_reduce: bad slot {slot[:1]!r}: "
                             "('count',) or ('sum', plain, factors)")


def slot_key(slot) -> tuple:
    """The identity of one code slot: its kind, plain column and factor
    list, each tensor by object identity."""
    if slot[0] == "count":
        return ("count",)
    _, plain, factors = slot
    return ("sum", None if plain is None else id(plain),
            tuple((id(c), id(d)) for c, d in factors))


def slot_values(slot, shape, dev) -> torch.Tensor:
    """One sum slot's row values in float32, in the kernel's order:
    ((plain * d1) * d2) * ..., each factor decoded from its batch's row
    (0 past the row, as on the TPU)."""
    from snappydata_tpu_torch.ops.kahan_reduce import decode_rows

    _, plain, factors = slot
    v = plain.to(torch.float32) if plain is not None \
        else torch.ones(shape, dtype=torch.float32, device=dev)
    for codes, dicts in factors:
        v = v * decode_rows(codes, dicts)
    return v


def grouped_code_reduce_plain(gidx: torch.Tensor, mask: torch.Tensor,
                              slots, num_segments: int) -> List[torch.Tensor]:
    """Plain PyTorch version of the kernel's arithmetic: each slot's f32
    product, then grouped_reduce_plain's lock-step Kahan chains (sums)
    and exact counts over the shared mask, combined in float64 / int64."""
    _check_code_slots(slots, num_segments)
    dev = gidx.device
    m = mask.reshape(-1).bool()
    g = gidx.reshape(-1)
    ops = []
    for slot in slots:
        if slot[0] == "count":
            ops.append(("count", None, m))
        else:
            ops.append(("sum", slot_values(slot, gidx.shape, dev)
                        .reshape(-1), m))
    out: List[torch.Tensor] = []
    for lo in range(0, len(ops), MAX_OPS):
        out.extend(grouped_reduce_plain(ops[lo:lo + MAX_OPS], g,
                                        num_segments))
    return out


def code_words(slots) -> int:
    """Partial words per group and thread of the code kernel for distinct
    `slots`: one per slot plus a compensation per sum."""
    return len(slots) + sum(s[0] == "sum" for s in slots)


def code_smem_bytes(words: int, num_segments: int, threads: int) -> int:
    """Shared memory of the partial chains of one block of the code
    kernel: `words` per group and thread."""
    return words * num_segments * threads * 4


def code_threads(words: int, num_segments: int) -> Optional[int]:
    """Threads per block of the code kernel: the most of 128, 64, 32
    whose partials fit SMEM_BUDGET; None past one warp."""
    return next((t for t in _CODE_THREADS
                 if code_smem_bytes(words, num_segments, t) <= SMEM_BUDGET),
                None)


def dict_span(width: int) -> int:
    """Entries one dictionary row takes in the code kernel's shared
    memory: zero-padded to 256, so a uint8 code needs no bounds check."""
    return max(width, 256)


def code_chunks(cap: int, threads: int) -> int:
    """Tiles per batch of the code kernel: chunks of 4 * threads rows."""
    return max(1, -(-cap // (4 * threads)))


def tile_range(block: int, blocks: int, total: int) -> Tuple[int, int]:
    """The contiguous tiles [lo, hi) block `block` of a persistent grid of
    `blocks` walks, out of `total` (batch, chunk) tiles in batch-major
    order — the kernel's own arithmetic."""
    return block * total // blocks, (block + 1) * total // blocks


def pack_code_spec(gidx: torch.Tensor, mask: torch.Tensor, chains,
                   num_segments: int
                   ) -> Tuple[_CodeSpec, int, int, bool, list]:
    """The code kernel's by-value spec for `chains` (distinct slots, sums
    first) over [B, cap] plates: (spec, words per group and thread,
    dictionary bytes of one batch, whether the four-row loads may run,
    the tensors it points at).  Raises on an input or a slot table the
    kernel cannot take.  The caller keeps the last element alive until
    the launch is enqueued."""
    if gidx.dim() != 2 or gidx.dtype != torch.int32:
        raise TypeError("grouped_code_reduce: [B, cap] int32 group index, "
                        f"got {gidx.dtype} of shape {tuple(gidx.shape)}")
    if len(chains) > MAX_CODE_SLOTS:
        raise ValueError(f"grouped_code_reduce: {len(chains)} distinct "
                         f"slots (1..{MAX_CODE_SLOTS})")
    B, cap = gidx.shape
    dev = gidx.device
    if B < 1:
        raise ValueError("grouped_code_reduce: no batches")
    keep: list = []

    def plate(a, types, what):
        if a.dtype not in types or tuple(a.shape) != (B, cap) \
                or a.device != dev:
            raise TypeError(f"grouped_code_reduce: {what} must be a "
                            f"[{B}, {cap}] tensor of {types} on {dev}")
        a = a.contiguous()
        keep.append(a)
        return a

    def check_dict(d):
        if d.dtype != torch.float32 or d.dim() != 2 or d.shape[0] != B \
                or d.device != dev:
            raise TypeError(f"grouped_code_reduce: dictionaries must be "
                            f"[{B}, D] float32 on {dev}")
        # an empty row decodes every code to 0, as a one-entry zero row
        # does; the kernel reads a clamped entry before it selects
        d = d.contiguous() if d.shape[1] else torch.zeros(
            (B, 1), dtype=torch.float32, device=dev)
        keep.append(d)
        return d

    # each distinct plain column, code plate and dictionary is made
    # contiguous once; slots that share one read the same addresses
    seen: Dict[int, torch.Tensor] = {}
    dicts: Dict[int, int] = {}   # id -> index among the distinct ones

    def intern(a, check):
        got = seen.get(id(a))
        if got is None:
            got = seen[id(a)] = check(a)
        return got

    spec = _CodeSpec()
    words = _fill_chains(spec.ch, [s[0] for s in chains], num_segments)
    g = plate(gidx, (torch.int32,), "gidx")
    m = plate(mask, (torch.bool,), "mask")
    spec.gidx, spec.mask = g.data_ptr(), m.data_ptr()
    spec.cap = cap
    spec.B = B
    aligned = cap % 4 == 0 and g.data_ptr() % 16 == 0 \
        and m.data_ptr() % 4 == 0
    n_extra = 0
    for k, slot in enumerate(chains):
        if slot[0] == "count":
            continue
        _, plain, factors = slot
        if plain is not None:
            pl = intern(plain, lambda a: plate(a, (torch.float32,), "plain"))
            spec.plain[k] = pl.data_ptr()
            aligned &= pl.data_ptr() % 16 == 0
        spec.n_factors[k] = len(factors)
        spec.extra0[k] = n_extra
        for h, (codes, dct) in enumerate(factors):
            if h < CODE_HOIST:
                fa = spec.factor[k][h]
            elif n_extra < MAX_CODE_EXTRA:
                fa = spec.extra[n_extra]
                n_extra += 1
            else:
                raise ValueError(
                    f"grouped_code_reduce: more than {MAX_CODE_EXTRA} code "
                    f"factors past the first {CODE_HOIST} of their slot")
            c = intern(codes, lambda a: plate(
                a, (torch.uint8, torch.uint16), "codes"))
            d = intern(dct, check_dict)
            if id(dct) not in dicts:
                if len(dicts) == MAX_CODE_DICTS:
                    raise ValueError(f"grouped_code_reduce: more than "
                                     f"{MAX_CODE_DICTS} distinct "
                                     f"dictionaries")
                di = dicts[id(dct)] = len(dicts)
                spec.dicts[di] = d.data_ptr()
                spec.dict_w[di] = int(d.shape[1])
                spec.dict_off[di] = sum(map(dict_span, spec.dict_w[:di]))
            di = dicts[id(dct)]
            fa.codes, fa.dict = c.data_ptr(), d.data_ptr()
            fa.code_bytes = c.element_size()
            fa.dict_w, fa.dict_off = spec.dict_w[di], spec.dict_off[di]
            aligned &= c.data_ptr() % (4 * c.element_size()) == 0
    spec.n_dicts = len(dicts)
    at = sum(map(dict_span, spec.dict_w[:spec.n_dicts]))
    return spec, words, 4 * at, aligned, keep


def grouped_code_reduce(gidx: torch.Tensor, mask: torch.Tensor, slots,
                        num_segments: int) -> List[torch.Tensor]:
    """Fused decode + filter + grouped reduction over code plates.

    gidx: [B, cap] int32 group index (< num_segments <= MAX_GROUPS; rows
    outside [0, num_segments) count nowhere); mask: [B, cap] bool shared
    row mask (valid & filter); slots: a sequence of ("count",) or
    ("sum", plain_or_None, factors), plain a [B, cap] float32 tensor and
    factors a sequence of (codes [B, cap] uint8/uint16, dicts [B, D]
    float32) — the slot value is plain * prod(dicts[b, codes]).  Identical
    slots are computed once; at most MAX_CODE_SLOTS distinct ones.
    Returns one [num_segments] tensor per slot: int64 for counts, float64
    for sums."""
    if gidx.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"grouped_code_reduce: no kernel for "
                           f"{gidx.device.type} tensors")
    _check_code_slots(slots, num_segments)
    firsts, where = chain_plan([slot_key(s) for s in slots],
                               [s[0] == "sum" for s in slots])
    chains = [slots[i] for i in firsts]
    if gidx.device.type == "cpu":
        res = grouped_code_reduce_plain(gidx, mask, chains, num_segments)
        return [res[j] for j in where]
    dev = gidx.device
    G = num_segments
    spec, words, dict_bytes, vec, keep = pack_code_spec(gidx, mask, chains,
                                                        G)
    # threads per block from the shared-memory budget, down to one warp
    threads = code_threads(words, G)
    if threads is None:
        raise ValueError(
            f"grouped_code_reduce: {len(chains)} slots over {G} groups need "
            f"{code_smem_bytes(words, G, 32)} bytes of shared memory at one "
            f"warp, past {SMEM_BUDGET}")
    smem = code_smem_bytes(words, G, threads)
    dsmem = smem + dict_bytes <= SMEM_BUDGET
    if dsmem:
        smem += dict_bytes
    # dictionaries too wide for shared memory take the one general kernel
    kb = _bucket(spec.ch.n_sums, _CODE_BUCKETS) if dsmem \
        else _CODE_BUCKETS[-1]
    per_sm = cuda_build.blocks_per_sm("group_code_reduce",
                                      "group_code_reduce_occupancy", kb,
                                      threads, int(dsmem), smem)
    sms = cuda_build.sm_count(dev)
    B, cap = gidx.shape
    tiles = B * code_chunks(cap, threads)
    if tiles >= 2 ** 31:
        raise ValueError(f"grouped_code_reduce: {tiles} tiles of "
                         f"{4 * threads} rows (under 2^31)")
    blocks = max(1, min(tiles, per_sm * sms))
    part = torch.empty((len(chains), G, blocks), dtype=torch.float64,
                       device=dev)
    out = torch.empty((len(chains), G), dtype=torch.float64, device=dev)
    rc = cuda_build.entry(*_GROUP_CODE_REDUCE)(
        ctypes.byref(spec), kb, threads, int(vec), int(dsmem),
        part.data_ptr(), blocks, out.data_ptr(), smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "group_code_reduce launch")
    grouped_code_reduce.launches += 1
    grouped_code_reduce.config = {
        "threads": threads, "blocks": blocks, "blocks_per_sm": per_sm,
        "bucket": kb, "words": words, "smem": smem, "dict_smem": dsmem,
        "tiles": tiles, "slots": len(slots), "chains": len(chains)}
    res = _typed_rows(out, [s[0] for s in chains], G)
    return [res[j] for j in where]


grouped_code_reduce.launches = 0
grouped_code_reduce.config = None

_GROUP_CODE_REDUCE = ("group_code_reduce", "group_code_reduce", [
    ctypes.POINTER(_CodeSpec), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p])
