"""Masked compensated (Kahan) sum of float32 values -> float64 scalar.

Replaces the TPU kernel snappydata_tpu/ops/pallas_reduce.py
masked_kahan_sum (`_kahan_kernel`, launched by `_kahan_call`): one pass
over the f32 plate where every chain keeps its own Kahan compensation,
and the chains' (sum, compensation) partials combine outside the kernel
in float64 as sum(s) - sum(c) — compensated summation keeps the error
near eps * sum(|v|) while the hot loop stays in native f32.

On Hopper (csrc/kahan_reduce.cu) the bound is bytes: 4 B of value and
1 B of mask per row against a handful of f32 adds, so the 3.35 TB/s of
HBM sets the pace.  The kernel is a grid-stride loop with 16-byte value
loads (float4 + uchar4 of mask) and one Kahan chain per thread in
registers, in place of the TPU's per-lane chains down a [rows, 128]
layout; each thread writes its (s, c) pair to a small partials tensor
and the f64 combine runs here.

`masked_kahan_sum` launches the kernel for a CUDA tensor (and counts the
launch in `masked_kahan_sum.launches`) and runs the plain version below
for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from snappydata_tpu_torch.ops import cuda_build

_THREADS = 256
# steps of the plain version's chains: chains = ceil(n / _PLAIN_STEPS)
_PLAIN_STEPS = 256


def masked_kahan_sum_plain(values: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: ceil(n / 256)
    Kahan chains advanced in lock step (Kahan: y = v - c; t = s + y;
    c = (t - s) - y; s = t), combined in float64 as sum(s) - sum(c)."""
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
    return s.double().sum() - c.double().sum()


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
    if values.shape != mask.shape or mask.device != values.device:
        raise ValueError("masked_kahan_sum: mask must match values in "
                         "shape and device")
    flat = values.reshape(-1).contiguous()
    m = mask.reshape(-1).contiguous()
    n = flat.numel()
    sms = torch.cuda.get_device_properties(flat.device).multi_processor_count
    blocks = max(1, min(-(-n // (_THREADS * 4)), sms * 8))
    part_s = torch.empty(blocks * _THREADS, dtype=torch.float32,
                         device=flat.device)
    part_c = torch.empty_like(part_s)
    lib = _lib()
    rc = lib.kahan_sum_f32(
        flat.data_ptr(), m.data_ptr(), n, part_s.data_ptr(),
        part_c.data_ptr(), blocks, _THREADS,
        torch.cuda.current_stream(flat.device).cuda_stream)
    cuda_build.check(rc, "kahan_sum_f32 launch")
    masked_kahan_sum.launches += 1
    return part_s.double().sum() - part_c.double().sum()


masked_kahan_sum.launches = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("kahan_reduce")
    fn = lib.kahan_sum_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return lib
