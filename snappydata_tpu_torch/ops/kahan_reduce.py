"""Compensated (Kahan) sums of float32 values -> float64: the masked
global sum, and the fused code-domain filter + sum of the Q6 shape.

Replaces the TPU kernel snappydata_tpu/ops/pallas_reduce.py
masked_kahan_sum (`_kahan_kernel`, launched by `_kahan_call`): one pass
over the f32 plate where every chain keeps its own Kahan compensation,
and the chains combine in float64 — compensated summation keeps the
error near eps * sum(|v|) while the hot loop stays in native f32.

On Hopper (csrc/kahan_reduce.cu) the bound is bytes: 4 B of value and
1 B of mask per row against a handful of f32 adds, so the 3.35 TB/s of
HBM sets the pace.  The kernel is one launch with one f64 output: a
grid-stride loop issuing several 16-byte value loads (and their mask
words) before the dependent adds, one Kahan chain per thread in place of
the TPU's per-lane chains down a [rows, 128] layout, each chain turned
into a float64 s - c and summed by warp, block and — in the last block to
finish, in a fixed order — across blocks.  `kahan_launch_plan` sizes the
grid; the wrapper keeps one block-partial buffer and ticket counter per
(device, stream) and allocates only the output per call.

`fused_code_filter_sum` replaces the TPU kernel
snappydata_tpu/ops/pallas_reduce.py fused_code_filter_sum
(`_fused_q6_kernel`, launched by `_fused_q6_call`): TPC-H Q6 over encoded
batches, where the quantity and discount columns stay uint8/uint16 code
plates compared against per-batch code thresholds the host translated
through each batch's sorted dictionary, the shipdate range is int32, and
the discount decodes inside the kernel from its batch's dictionary row.
On Hopper (csrc/code_filter_sum.cu) it is bound by bytes too — 11 B per
row with uint8 codes — and runs one block row per batch, so a block reads
its batch's thresholds and dictionary once (the dictionary into shared
memory), with one Kahan chain and an exact integer count per thread.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
in `<wrapper>.launches`) and runs the plain version for CPU tensors; any
other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from snappydata_tpu_torch.ops import cuda_build

_THREADS = 256
# float4 steps (16 rows each) a thread streams at least before the grid
# grows, so the block and cross-block combine stay small beside the stream
_MIN_STEPS = 16
# steps of the plain version's chains: chains = ceil(n / _PLAIN_STEPS)
_PLAIN_STEPS = 256


def kahan_launch_plan(n: int, sms: int,
                      blocks_per_sm: int) -> Tuple[int, int, int]:
    """(blocks, threads, steps) of the kernel over n rows: as many blocks
    as give every thread at least _MIN_STEPS float4 steps, at most the
    resident blocks of the card (sms x blocks_per_sm) and at least one;
    steps is the float4 steps of the busiest thread."""
    n4 = n // 4
    blocks = max(1, min(sms * blocks_per_sm, n4 // (_THREADS * _MIN_STEPS)))
    steps = -(-n4 // (blocks * _THREADS))
    return blocks, _THREADS, steps


def kahan_layout(n: int, values_ptr: int,
                 mask_ptr: int) -> Tuple[bool, int, int]:
    """(vector, head, n4): whether the kernel's float4 loop runs over the
    f32 values at `values_ptr` and the bool mask at `mask_ptr`, the rows
    peeled before it (until the value base is 16-byte aligned) and its
    float4 steps.  The loop runs when the mask base is 4-byte aligned at
    the same row, i.e. when the two offsets agree modulo 4 rows;
    otherwise every row is read alone (head 0, n4 0)."""
    head = (-(values_ptr // 4)) % 4
    if values_ptr % 4 or (mask_ptr + head) % 4:
        return False, 0, 0
    head = min(n, head)
    return True, head, (n - head) // 4


def masked_kahan_sum_plain(values: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: ceil(n / 256)
    Kahan chains advanced in lock step (Kahan: y = v - c; t = s + y;
    c = (t - s) - y; s = t), each turned into a float64 s - c and summed
    in float64, as the kernel combines its chains."""
    flat = values.reshape(-1).to(torch.float32)
    m = mask.reshape(-1)
    n = flat.numel()
    chains = max(1, -(-n // _PLAIN_STEPS))
    v = torch.zeros(_PLAIN_STEPS * chains, dtype=torch.float32,
                    device=flat.device)
    v[:n] = torch.where(m, flat, torch.zeros((), dtype=torch.float32,
                                             device=flat.device))
    v = v.view(_PLAIN_STEPS, chains)
    s = torch.zeros(chains, dtype=torch.float32, device=flat.device)
    c = torch.zeros_like(s)
    for i in range(_PLAIN_STEPS):
        y = v[i] - c
        t = s + y
        c = (t - s) - y
        s = t
    # c holds the excess already folded into s: the chain total is s - c
    return (s.double() - c.double()).sum()


# per (device index, stream): the block partials and the ticket counter,
# which the kernel leaves at 0 when it ends
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def masked_kahan_sum(values: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Compensated sum of values[mask] -> float64 0-dim tensor.

    `values`: any-shape float32 tensor; `mask`: same-shape bool."""
    if values.device.type == "cpu":
        return masked_kahan_sum_plain(values, mask)
    if values.device.type != "cuda":
        raise RuntimeError(f"masked_kahan_sum: no kernel for "
                           f"{values.device.type} tensors")
    if values.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("masked_kahan_sum takes float32 values and a bool "
                        f"mask, got {values.dtype} / {mask.dtype}")
    dev = values.device
    if values.shape != mask.shape or mask.device != dev:
        raise ValueError("masked_kahan_sum: mask must match values in "
                         "shape and device")
    if not values.is_contiguous():
        values = values.contiguous()
    if not mask.is_contiguous():
        mask = mask.contiguous()
    n = values.numel()
    vp, mp = values.data_ptr(), mask.data_ptr()
    vector, head, n4 = kahan_layout(n, vp, mp)
    per_sm = cuda_build.blocks_per_sm("kahan_reduce", "kahan_occupancy",
                                      _THREADS, 0)
    sms = cuda_build.sm_count(dev)
    blocks, threads, steps = kahan_launch_plan(n, sms, per_sm)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = _scratch[key] = (
            torch.empty(sms * per_sm, dtype=torch.float64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    part, counter = scratch
    out = torch.empty((), dtype=torch.float64, device=dev)
    rc = cuda_build.entry(*_KAHAN)(
        vp, mp, n, head, n4, part.data_ptr(), counter.data_ptr(),
        out.data_ptr(), blocks, threads, stream)
    cuda_build.check(rc, "kahan_sum_f32 launch")
    masked_kahan_sum.launches += 1
    masked_kahan_sum.config = {
        "threads": threads, "blocks": blocks, "blocks_per_sm": per_sm,
        "steps": steps, "vector": vector, "peeled": head}
    return out


masked_kahan_sum.launches = 0
masked_kahan_sum.config = None


def decode_rows(codes: torch.Tensor, dicts: torch.Tensor) -> torch.Tensor:
    """dicts[b, codes[b, i]] as float32, 0 where a code lies past the
    dictionary row (as the TPU kernel's select chain leaves it)."""
    c = codes.long()
    d = dicts.to(torch.float32)
    width = d.shape[1]
    if width == 0:
        return torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    got = torch.gather(d, 1, c.clamp(max=width - 1))
    return torch.where(c < width, got, torch.zeros((), dtype=torch.float32,
                                                   device=c.device))


def code_filter_mask(qty_codes, disc_codes, ship, valid, qty_hi_codes,
                     disc_lo_codes, disc_hi_codes, ship_lo, ship_hi):
    """The rows `fused_code_filter_sum` keeps, as a bool [B, cap] mask."""
    q = qty_codes.long()
    d = disc_codes.long()
    sh = ship.long()
    qhi = qty_hi_codes.reshape(-1, 1).long()
    dlo = disc_lo_codes.reshape(-1, 1).long()
    dhi = disc_hi_codes.reshape(-1, 1).long()
    return (valid.bool() & (q < qhi) & (d >= dlo) & (d <= dhi)
            & (sh >= int(ship_lo)) & (sh < int(ship_hi)))


def fused_code_filter_sum_plain(qty_codes, disc_codes, ship, price, valid,
                                disc_dicts, qty_hi_codes, disc_lo_codes,
                                disc_hi_codes, ship_lo, ship_hi):
    """Plain PyTorch version of the kernel's arithmetic: the same code and
    shipdate compares, the discount decoded from its batch's row, the f32
    product price * disc, then compensated f32 chains combined in float64
    (masked_kahan_sum_plain) and an int64 count."""
    ok = code_filter_mask(qty_codes, disc_codes, ship, valid, qty_hi_codes,
                          disc_lo_codes, disc_hi_codes, ship_lo, ship_hi)
    prod = price.to(torch.float32) * decode_rows(disc_codes, disc_dicts)
    return masked_kahan_sum_plain(prod, ok), ok.sum().to(torch.int64)


def fused_code_filter_sum(qty_codes, disc_codes, ship, price, valid,
                          disc_dicts, qty_hi_codes, disc_lo_codes,
                          disc_hi_codes, ship_lo, ship_hi):
    """Fused decode + filter + SUM over encoded batches (the Q6 shape):

        sum(price * disc), count(*)
        WHERE valid
          AND qty_code < qty_hi_codes[b]            (code domain)
          AND disc_lo_codes[b] <= disc_code <= disc_hi_codes[b]
          AND ship_lo <= ship < ship_hi              (int32 value domain)

    qty_codes / disc_codes: [B, cap] uint8/uint16 code plates; ship:
    [B, cap] int32; price: [B, cap] float32; valid: [B, cap] bool;
    disc_dicts: [B, D] float32 per-batch dictionaries (decode target);
    the three thresholds: [B] int32, translated on the host through each
    batch's sorted dictionary (a miss yields a threshold that matches
    nothing).  Returns (float64 0-dim sum, int64 0-dim count)."""
    if price.device.type == "cpu":
        return fused_code_filter_sum_plain(
            qty_codes, disc_codes, ship, price, valid, disc_dicts,
            qty_hi_codes, disc_lo_codes, disc_hi_codes, ship_lo, ship_hi)
    if price.device.type != "cuda":
        raise RuntimeError(f"fused_code_filter_sum: no kernel for "
                           f"{price.device.type} tensors")
    dev = price.device
    if price.dim() != 2:
        raise ValueError("fused_code_filter_sum: [B, cap] plates expected")
    B, cap = price.shape
    code_types = (torch.uint8, torch.uint16)
    want = ((qty_codes, code_types), (disc_codes, code_types),
            (ship, (torch.int32,)), (price, (torch.float32,)),
            (valid, (torch.bool,)))
    for a, types in want:
        if a.dtype not in types or tuple(a.shape) != (B, cap) \
                or a.device != dev:
            raise TypeError(
                f"fused_code_filter_sum: a [{B}, {cap}] input on {dev} of "
                f"{a.dtype} (expected one of {types})")
    if disc_dicts.dtype != torch.float32 or disc_dicts.dim() != 2 \
            or disc_dicts.shape[0] != B or disc_dicts.device != dev:
        raise TypeError("fused_code_filter_sum: disc_dicts must be "
                        f"[{B}, D] float32 on {dev}")
    if not 1 <= B <= 65535:
        raise ValueError(f"fused_code_filter_sum: {B} batches (1..65535)")

    def thresholds(a):
        t = torch.as_tensor(a, dtype=torch.int32).reshape(-1).to(dev)
        if t.numel() != B:
            raise ValueError(f"fused_code_filter_sum: [{B}] thresholds, "
                             f"got {t.numel()}")
        return t.contiguous()

    qhi, dlo, dhi = (thresholds(a) for a in
                     (qty_hi_codes, disc_lo_codes, disc_hi_codes))
    ins = [a.contiguous() for a in (qty_codes, disc_codes, ship, price,
                                    valid)]
    q, d, sh, pz, vd = ins
    dicts = disc_dicts.contiguous()
    # four-row loads need rows of 4 and aligned bases (16 B for int/float,
    # 4 B per code byte, 4 B for the validity bytes)
    vec = cap % 4 == 0 and all(
        a.data_ptr() % (4 * a.element_size()) == 0 for a in ins)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks_x = max(1, min(-(-cap // (_THREADS * 4)), -(-sms * 4 // B)))
    total = B * blocks_x * _THREADS
    part_s = torch.empty(total, dtype=torch.float32, device=dev)
    part_c = torch.empty_like(part_s)
    part_n = torch.empty(total, dtype=torch.int64, device=dev)
    rc = cuda_build.entry(*_CODE_FILTER)(
        q.data_ptr(), q.element_size(), d.data_ptr(), d.element_size(),
        sh.data_ptr(), pz.data_ptr(), vd.data_ptr(), dicts.data_ptr(),
        dicts.shape[1], qhi.data_ptr(), dlo.data_ptr(), dhi.data_ptr(),
        int(ship_lo), int(ship_hi), B, cap, int(vec), part_s.data_ptr(),
        part_c.data_ptr(), part_n.data_ptr(), blocks_x, _THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "code_filter_sum launch")
    fused_code_filter_sum.launches += 1
    return (part_s.double().sum() - part_c.double().sum(),
            part_n.sum())


fused_code_filter_sum.launches = 0

# the C entry points: (source under csrc/, function, argument types)
_KAHAN = ("kahan_reduce", "kahan_sum_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_CODE_FILTER = ("code_filter_sum", "code_filter_sum", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
