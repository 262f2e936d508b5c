"""Fused grouped reductions in one pass: SUM / COUNT / MIN / MAX over
float32 values (`grouped_reduce`), and COUNT / SUM of decoded code-plate
products (`grouped_code_reduce`).

Replaces the TPU kernel snappydata_tpu/ops/pallas_group.py
grouped_reduce (kernel from `_make_kernel`, launched by `_grouped_call`):
the dictionary fast path of a GROUP BY (TPC-H Q1: a handful of SUM/AVG/
COUNT slots over G <= 64 groups, the executor's +1 overflow segment
included) computes every fused slot in ONE streaming pass that shares the
group-index load.  Sums keep a Kahan compensation per chain and combine
outside the kernel in float64 as sum(s) - sum(c); counts are exact
integers; MIN/MAX start from +/-inf, so an empty group keeps the filler
the packed families produce.

On Hopper (csrc/group_reduce.cu) the bound is bytes: 4 B of group index,
1 B per distinct mask and 4 B per distinct value column per row, against
a few f32 adds per slot.  Where the TPU kept [G, 8, 128] per-lane carries
in VMEM, the kernel keeps G x words partial chains per THREAD in shared
memory, one private column per thread (word w of group g of thread t at
[(w * G + g) * T + t]): no races, no atomics, and neighbouring threads
hit neighbouring banks whatever their groups.  `op_smem_bytes` is that
shared-memory budget — the executor stops fusing slots before a block
would need more than the 227 KB an SM offers, as the VMEM budget did on
the TPU.  Each block folds its threads' chains and writes one float64 per
(slot, group); the blocks combine here in float64 / int64.

The wrapper keeps the reference's dedup of inputs by identity: slots that
share a mask (all of Q1's) or a value column read it once per row.
`grouped_code_reduce` replaces the TPU kernel
snappydata_tpu/ops/pallas_group.py grouped_code_reduce (kernel from
`_make_code_kernel`, launched by `_grouped_code_call`): the Q1 shape over
encoded batches, one shared row mask, each slot a count or the Kahan sum
of (an optional plain f32 column) x the product of code factors decoded
from per-batch dictionaries (`1 - disc`, `1 + tax` transformed on the
host).  Its kernel (csrc/group_code_reduce.cu) keeps group_reduce.cu's
private shared-memory columns, runs one block row per batch so the
dictionaries load into shared memory once per block, and takes its
threads per block from SMEM_BUDGET, down to one warp.

Each wrapper launches its kernel for CUDA tensors (counted in
`<wrapper>.launches`) and runs the plain version for CPU tensors; any
other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from snappydata_tpu_torch.ops import cuda_build

# G cap, counting the +1 overflow segment the executor reserves for
# invalid rows (same regime as reduction.UNROLL_MAX_SEGMENTS)
MAX_GROUPS = 64
# the kernel's fixed op table (csrc/group_reduce.cu GR_MAX_OPS)
MAX_OPS = 32
THREADS = 128
# shared memory one block may use on Hopper (232,448 bytes)
SMEM_BUDGET = 227 * 1024

_KINDS = ("sum", "count", "min", "max")
# steps of the plain version's chains: chains = ceil(n / _PLAIN_STEPS)
_PLAIN_STEPS = 256


def _words(kind: str) -> int:
    return 2 if kind == "sum" else 1


def op_smem_bytes(kind: str, num_segments: int) -> int:
    """Shared memory one fused op adds to a block: its per-thread,
    per-group partial words (two for a Kahan sum)."""
    return _words(kind) * num_segments * THREADS * 4


class _GroupSpec(ctypes.Structure):
    _fields_ = [("n_ops", ctypes.c_int),
                ("kind", ctypes.c_int * MAX_OPS),
                ("word", ctypes.c_int * MAX_OPS),
                ("values", ctypes.c_void_p * MAX_OPS),
                ("masks", ctypes.c_void_p * MAX_OPS)]


def _check_ops(ops, num_segments: int) -> None:
    if not 1 <= num_segments <= MAX_GROUPS:
        raise ValueError(f"grouped_reduce: {num_segments} segments "
                         f"(1..{MAX_GROUPS})")
    if not 1 <= len(ops) <= MAX_OPS:
        raise ValueError(f"grouped_reduce: {len(ops)} ops (1..{MAX_OPS})")
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


def grouped_reduce(ops: Sequence[Tuple[str, Optional[torch.Tensor],
                                       torch.Tensor]],
                   gidx: torch.Tensor,
                   num_segments: int) -> List[torch.Tensor]:
    """Fused segmented reduction of all `ops` in one streaming pass.

    ops: (kind, values, mask) per aggregate slot — kind in
    sum/count/min/max, values a float32 tensor (None for count), mask the
    slot's validity (row valid AND value non-null).  gidx: int32 group
    index per element, < num_segments <= MAX_GROUPS.  Returns one
    [num_segments] tensor per op: float64 for sums, int64 for counts,
    float32 (with +/-inf empty-group fillers) for min/max."""
    if gidx.device.type == "cpu":
        return grouped_reduce_plain(ops, gidx, num_segments)
    if gidx.device.type != "cuda":
        raise RuntimeError(f"grouped_reduce: no kernel for "
                           f"{gidx.device.type} tensors")
    _check_ops(ops, num_segments)
    if gidx.dtype != torch.int32:
        raise TypeError(f"grouped_reduce: int32 group index, got "
                        f"{gidx.dtype}")
    dev = gidx.device
    g = gidx.reshape(-1).contiguous()
    n = g.numel()
    # deduplicate inputs by source identity: slots that share a mask or
    # a value column hand the kernel one pointer, read once per row
    keep: Dict[Tuple[int, str], torch.Tensor] = {}

    def intern(a, role, dtype) -> int:
        key = (id(a), role)
        got = keep.get(key)
        if got is None:
            if a.dtype != dtype or a.device != dev or a.numel() != n:
                raise TypeError(
                    f"grouped_reduce: {role} input must be {dtype} with "
                    f"{n} elements on {dev}")
            got = keep[key] = a.reshape(-1).contiguous()
        return got.data_ptr()

    spec = _GroupSpec()
    spec.n_ops = len(ops)
    words = 0
    for i, (k, v, m) in enumerate(ops):
        spec.kind[i] = _KINDS.index(k)
        spec.word[i] = words
        words += _words(k)
        spec.masks[i] = intern(m, "mask", torch.bool)
        spec.values[i] = None if k == "count" \
            else intern(v, "value", torch.float32)
    smem = words * num_segments * THREADS * 4
    if smem > SMEM_BUDGET:
        raise ValueError(f"grouped_reduce: {smem} bytes of shared memory "
                         f"exceed the {SMEM_BUDGET}-byte budget")
    # the kernel's four-row loads need 16-byte aligned index and values
    # and 4-byte aligned masks; otherwise it reads row by row
    vec = g.data_ptr() % 16 == 0 and all(
        t.data_ptr() % (4 if role == "mask" else 16) == 0
        for (_, role), t in keep.items())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, SMEM_BUDGET // max(1, smem))
    blocks = max(1, min(-(-n // (THREADS * 4)), sms * min(per_sm, 8)))
    part = torch.empty((blocks, len(ops), num_segments),
                       dtype=torch.float64, device=dev)
    rc = cuda_build.entry(*_GROUP_REDUCE)(
        g.data_ptr(), n, ctypes.byref(spec), num_segments, int(vec),
        part.data_ptr(), blocks, THREADS, smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "group_reduce_f32 launch")
    grouped_reduce.launches += 1
    out = []
    for i, (k, _v, _m) in enumerate(ops):
        p = part[:, i, :]
        if k == "sum":
            out.append(p.sum(0))
        elif k == "count":
            # per-block counts are exact integers in float64 (< 2^53)
            out.append(p.sum(0).round().to(torch.int64))
        elif k == "min":
            out.append(p.amin(0).to(torch.float32))
        else:
            out.append(p.amax(0).to(torch.float32))
    return out


grouped_reduce.launches = 0


# the C entry points: (source under csrc/, function, argument types)
_GROUP_REDUCE = ("group_reduce", "group_reduce_f32", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(_GroupSpec),
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
_GROUP_CODE_REDUCE = ("group_code_reduce", "group_code_reduce", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])


# --- grouped reduction over code plates (the Q1 shape) ---------------------

_CODE_THREADS = (128, 64, 32)


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


def code_smem_bytes(words: int, num_segments: int, threads: int) -> int:
    """Shared memory of the partial chains of one block of the code
    kernel: `words` per group and thread (two per sum, one per count)."""
    return words * num_segments * threads * 4


def code_threads(words: int, num_segments: int,
                 spec_bytes: int = 0) -> Optional[int]:
    """Threads per block of the code kernel: the most of 128, 64, 32
    whose partials and slot spec fit SMEM_BUDGET; None past one warp."""
    return next((t for t in _CODE_THREADS
                 if spec_bytes + code_smem_bytes(words, num_segments, t)
                 <= SMEM_BUDGET), None)


def grouped_code_reduce(gidx: torch.Tensor, mask: torch.Tensor, slots,
                        num_segments: int) -> List[torch.Tensor]:
    """Fused decode + filter + grouped reduction over code plates.

    gidx: [B, cap] int32 group index (< num_segments <= MAX_GROUPS; rows
    outside [0, num_segments) count nowhere); mask: [B, cap] bool shared
    row mask (valid & filter); slots: a sequence of ("count",) or
    ("sum", plain_or_None, factors), plain a [B, cap] float32 tensor and
    factors a sequence of (codes [B, cap] uint8/uint16, dicts [B, D]
    float32) — the slot value is plain * prod(dicts[b, codes]).  Returns
    one [num_segments] tensor per slot: int64 for counts, float64 for
    sums."""
    if gidx.device.type == "cpu":
        return grouped_code_reduce_plain(gidx, mask, slots, num_segments)
    if gidx.device.type != "cuda":
        raise RuntimeError(f"grouped_code_reduce: no kernel for "
                           f"{gidx.device.type} tensors")
    _check_code_slots(slots, num_segments)
    dev = gidx.device
    if gidx.dim() != 2 or gidx.dtype != torch.int32:
        raise TypeError("grouped_code_reduce: [B, cap] int32 group index, "
                        f"got {gidx.dtype} of shape {tuple(gidx.shape)}")
    B, cap = gidx.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"grouped_code_reduce: {B} batches (1..65535)")

    def plate(a, types, what):
        if a.dtype not in types or tuple(a.shape) != (B, cap) \
                or a.device != dev:
            raise TypeError(f"grouped_code_reduce: {what} must be a "
                            f"[{B}, {cap}] tensor of {types} on {dev}")
        return a.contiguous()

    g = gidx.contiguous()
    m = plate(mask, (torch.bool,), "mask")
    # deduplicate inputs by identity: each distinct plain column, code
    # plate and dictionary is one pointer, read once per row
    plains: Dict[int, Tuple[int, torch.Tensor]] = {}
    codes_in: Dict[int, Tuple[int, torch.Tensor]] = {}
    dicts_in: Dict[int, Tuple[int, torch.Tensor]] = {}

    def intern(table, a, check):
        got = table.get(id(a))
        if got is None:
            got = table[id(a)] = (len(table), check(a))
        return got[0]

    def check_dict(d):
        if d.dtype != torch.float32 or d.dim() != 2 or d.shape[0] != B \
                or d.device != dev:
            raise TypeError(f"grouped_code_reduce: dictionaries must be "
                            f"[{B}, D] float32 on {dev}")
        return d.contiguous()

    slot_rows, factor_rows = [], []
    words = 0
    for slot in slots:
        if slot[0] == "count":
            slot_rows.append((1, words, -1, 0, 0))
            words += 1
            continue
        _, plain, factors = slot
        pi = -1 if plain is None else intern(
            plains, plain, lambda a: plate(a, (torch.float32,), "plain"))
        first = len(factor_rows)
        for codes, dicts in factors:
            factor_rows.append((
                intern(codes_in, codes, lambda a: plate(
                    a, (torch.uint8, torch.uint16), "codes")),
                intern(dicts_in, dicts, check_dict)))
        slot_rows.append((0, words, pi, len(factors), first))
        words += 2
    code_list = [t for _, t in sorted(codes_in.values(), key=lambda x: x[0])]
    dict_list = [t for _, t in sorted(dicts_in.values(), key=lambda x: x[0])]
    plain_list = [t for _, t in sorted(plains.values(), key=lambda x: x[0])]
    widths = [int(d.shape[1]) for d in dict_list]
    offsets, at = [], 0
    for w in widths:
        offsets.append(at)
        at += w
    spec = [len(slots), len(plain_list), len(code_list), len(dict_list),
            len(factor_rows), words]
    for row in slot_rows:
        spec.extend(row)
    for row in factor_rows:
        spec.extend(row)
    spec.extend(c.element_size() for c in code_list)
    spec.extend(widths)
    spec.extend(offsets)
    spec_bytes = 4 * len(spec)
    dict_bytes = 4 * at
    # threads per block from the shared-memory budget, down to one warp
    threads = code_threads(words, num_segments, spec_bytes)
    if threads is None:
        raise ValueError(
            f"grouped_code_reduce: {len(slots)} slots over {num_segments} "
            f"groups need {code_smem_bytes(words, num_segments, 32)} bytes "
            f"of shared memory at one warp, past {SMEM_BUDGET}")
    smem = spec_bytes + code_smem_bytes(words, num_segments, threads)
    dsmem = smem + dict_bytes <= SMEM_BUDGET
    if dsmem:
        smem += dict_bytes
    ptr_list = plain_list + code_list + dict_list
    spec_t = torch.tensor(spec, dtype=torch.int32).to(dev)
    ptrs_t = torch.tensor([t.data_ptr() for t in ptr_list] or [0],
                          dtype=torch.int64).to(dev)
    vec = cap % 4 == 0 and g.data_ptr() % 16 == 0 \
        and m.data_ptr() % 4 == 0 \
        and all(t.data_ptr() % 16 == 0 for t in plain_list) \
        and all(t.data_ptr() % (4 * t.element_size()) == 0
                for t in code_list)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, min(8, SMEM_BUDGET // smem))
    blocks_x = max(1, min(-(-cap // (threads * 4)),
                          -(-sms * per_sm // B)))
    part = torch.empty((B * blocks_x, len(slots), num_segments),
                       dtype=torch.float64, device=dev)
    rc = cuda_build.entry(*_GROUP_CODE_REDUCE)(
        g.data_ptr(), m.data_ptr(), B, cap, spec_t.data_ptr(), len(spec),
        ptrs_t.data_ptr(), num_segments, int(vec), int(dsmem),
        part.data_ptr(), blocks_x, threads, smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "group_code_reduce launch")
    grouped_code_reduce.launches += 1
    sums = part.sum(0)
    return [sums[i].round().to(torch.int64) if slot[0] == "count"
            else sums[i] for i, slot in enumerate(slots)]


grouped_code_reduce.launches = 0
