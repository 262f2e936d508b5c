"""Fused segmented reductions for grouped aggregation.

Port of snappydata_tpu/ops/reduction.py.  The executor packs every
compatible aggregate slot into one [N, S] value matrix per accumulator
family and reduces the whole family in one dispatch:

  unroll   G masked reductions over the packed block (few segments)
  scatter  one `index_add_` / `scatter_reduce` pass along axis 0
  matmul   one-hot [S, N] @ [N, G] in the accumulator dtype

`agg_reduce_strategy` (config.py) picks one explicitly; `auto` keys on
backend + G + S + N (`resolve_strategy`), with the reference's table.
Where the reference gates on a TPU backend, the port takes the
reference's non-TPU branch on both the CPU and CUDA, so `auto` sends a
float-sum family with more than CPU_UNROLL_MAX_SEGMENTS groups to the
one-hot matmul while the one-hot fits MATMUL_ONEHOT_MAX_BYTES.  The
product is a plain `torch.matmul`: the reference leaves it to XLA, not
to a Pallas kernel.

Exactness contract per family (unchanged):
  float sums  f64 accumulation (reordered summation only)
  int sums    int64 unroll/scatter only, never matmul (an f64 dot loses
              bits above 2**53)
  counts      exact on every strategy (f64 0/1 columns below 2**53 rows,
              or bound-checked int accumulators)
  min/max     order-independent; empty groups keep the +/-inf and
              integer-extreme fillers
"""

from __future__ import annotations

import torch

STRATEGIES = ("auto", "unroll", "scatter", "matmul")

# unroll's G-masked-reductions shape only wins in the small-G dictionary
# regime; past this it degrades to scatter even if requested
UNROLL_MAX_SEGMENTS = 64

# the reference's non-TPU unroll ceiling (a handful of segments: global
# aggregates and tiny groupings, TPC-H Q6's shape)
CPU_UNROLL_MAX_SEGMENTS = 4

# matmul materializes a [N, G] one-hot in the accumulator dtype: bound it
# so a large-G or huge-N aggregate falls back to scatter instead of
# exploding memory (the reference's bound)
MATMUL_ONEHOT_MAX_BYTES = 4 << 30

# int32 count accumulators are exact only while a group can hold fewer
# than 2**31 rows; above that the packed count dtype widens to int64
COUNT_I32_MAX_ROWS = (1 << 31) - 1


def count_pack_dtype(n_rows: int) -> torch.dtype:
    """Accumulator dtype for packed int counts: int32 while no group can
    reach 2**31 rows, int64 beyond."""
    return torch.int32 if n_rows <= COUNT_I32_MAX_ROWS else torch.int64


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    import numpy as np

    return np.dtype(dtype).itemsize


def onehot_bytes(n_rows: int, num_segments: int, acc_dtype) -> int:
    return int(n_rows) * int(num_segments) * _itemsize(acc_dtype)


def resolve_strategy(requested: str, backend: str, num_segments: int,
                     n_rows: int, family: str, acc_dtype) -> str:
    """Pick the fused strategy for one accumulator family.

    family: "fsum" (float sums + counts-as-f64), "isum" (exact int64
    sums), "minmax".  Invalid requests degrade rather than fail: matmul
    is refused for int sums (inexact) and min/max (not a dot), and for
    one-hots past MATMUL_ONEHOT_MAX_BYTES; unroll degrades to scatter
    past UNROLL_MAX_SEGMENTS.  `backend` is the torch device type; only
    "tpu" (which the port never sees) takes the reference's TPU rows.
    """
    if requested not in STRATEGIES:
        requested = "auto"
    if requested == "matmul" and (
            family != "fsum"
            or onehot_bytes(n_rows, num_segments, acc_dtype)
            > MATMUL_ONEHOT_MAX_BYTES):
        requested = "auto"
    if requested == "unroll" and num_segments > UNROLL_MAX_SEGMENTS:
        requested = "scatter"
    if requested != "auto":
        return requested
    small = num_segments <= (UNROLL_MAX_SEGMENTS if backend == "tpu"
                             else CPU_UNROLL_MAX_SEGMENTS)
    if small:
        return "unroll"
    if family == "fsum" and backend != "tpu" and onehot_bytes(
            n_rows, num_segments, acc_dtype) <= MATMUL_ONEHOT_MAX_BYTES:
        return "matmul"
    return "scatter"


def make_onehot(gidx: torch.Tensor, num_segments: int,
                acc_dtype: torch.dtype) -> torch.Tensor:
    """[N, G] one-hot of the (already validity-masked) group index in the
    accumulator dtype.  Callers pass the REAL group count: rows whose gidx
    points at the excluded overflow segment match no column and become
    all-zero rows, contributing nothing to any group."""
    ar = torch.arange(num_segments, dtype=gidx.dtype, device=gidx.device)
    return (gidx[:, None] == ar[None, :]).to(acc_dtype)


def _pack(cols) -> torch.Tensor:
    if len(cols) == 1:
        return cols[0][:, None]
    return torch.stack(cols, dim=1)


def _scatter_sum(packed: torch.Tensor, gidx: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments + 1, packed.shape[1]),
                      dtype=packed.dtype, device=packed.device)
    out.index_add_(0, gidx.long(), packed)
    return out[:num_segments]


def packed_sum(cols, gidx: torch.Tensor, num_segments: int,
               strategy: str, onehot=None) -> torch.Tensor:
    """Fused segmented SUM of a family's columns (list of [N] tensors)
    -> [num_segments, S].  Rows must already be masked into the additive
    identity (0); rows whose gidx is num_segments (the executor's
    overflow segment) are dropped.

    matmul caveat: NaN/Inf values leak across groups through the dot
    (NaN * one-hot-zero is NaN), so a float matmul checks that every
    packed value is finite and otherwise takes the group-isolating
    scatter — the reference's `lax.cond`, read here as one device-to-host
    flag."""
    if strategy == "unroll" and num_segments <= UNROLL_MAX_SEGMENTS:
        outs = []
        for k in range(num_segments):
            m = gidx == k
            outs.append(torch.stack([
                torch.where(m, c, torch.zeros((), dtype=c.dtype,
                                              device=c.device))
                .sum(dtype=c.dtype) for c in cols]))
        return torch.stack(outs)
    packed = _pack(cols)
    if strategy == "matmul":
        # integer packs never reach matmul through resolve_strategy (the
        # executor joins counts into the f64 pack as 0/1 columns); a
        # direct integer request keeps the exact scatter, since CUDA has
        # no integer matmul
        if not packed.is_floating_point() \
                or not bool(torch.isfinite(packed).all()):
            return _scatter_sum(packed, gidx, num_segments)
        oh = make_onehot(gidx, num_segments, packed.dtype) \
            if onehot is None else onehot
        return torch.matmul(packed.T, oh).T
    return _scatter_sum(packed, gidx, num_segments)


def packed_minmax(kind: str, cols, gidx: torch.Tensor, num_segments: int,
                  strategy: str) -> torch.Tensor:
    """Fused segmented MIN/MAX of a family's columns (list of [N]
    tensors).  Rows must already be masked to the identity filler;
    empty segments yield that filler."""
    fill = extreme_value(cols[0].dtype, kind == "min")
    if strategy == "unroll" and num_segments <= UNROLL_MAX_SEGMENTS:
        op = torch.amin if kind == "min" else torch.amax
        outs = []
        for k in range(num_segments):
            m = gidx == k
            outs.append(torch.stack([op(torch.where(m, c, fill))
                                     for c in cols]))
        return torch.stack(outs)
    packed = _pack(cols)
    out = torch.full((num_segments + 1, packed.shape[1]),
                     extreme_value(packed.dtype, kind == "min"),
                     dtype=packed.dtype, device=packed.device)
    idx = gidx.long()[:, None].expand_as(packed)
    out.scatter_reduce_(0, idx, packed,
                        "amin" if kind == "min" else "amax",
                        include_self=True)
    return out[:num_segments]


def extreme_value(dtype: torch.dtype, positive: bool):
    """Identity filler for min (positive) / max as a Python number (no
    device round trip)."""
    if dtype.is_floating_point:
        return float("inf") if positive else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if positive else info.min
