"""Fused segmented reductions for grouped aggregation.

Port of snappydata_tpu/ops/reduction.py.  The executor packs every
compatible aggregate slot into one [N, S] value matrix per accumulator
family and reduces the whole family in one dispatch:

  unroll   G masked reductions over the packed block (few segments)
  scatter  one `index_add_` / `scatter_reduce` pass along axis 0

`agg_reduce_strategy` (config.py) picks one explicitly; `auto` keys on G.
Where the reference gates on a TPU backend, the port takes the reference's
CPU branch.  The one-hot matmul strategy is not ported: a `matmul`
request (or the CPU branch's matmul choice) runs `scatter`.

Exactness contract per family (unchanged):
  float sums  f64 accumulation (reordered summation only)
  int sums    int64 unroll/scatter
  counts      exact on every strategy (bound-checked int accumulators)
  min/max     order-independent; empty groups keep the +/-inf and
              integer-extreme fillers
"""

from __future__ import annotations

import torch

STRATEGIES = ("auto", "unroll", "scatter", "matmul")

# unroll's G-masked-reductions shape only wins in the small-G dictionary
# regime; past this it degrades to scatter even if requested
UNROLL_MAX_SEGMENTS = 64

# the reference's CPU-branch unroll ceiling (a handful of segments:
# global aggregates and tiny groupings, TPC-H Q6's shape)
CPU_UNROLL_MAX_SEGMENTS = 4

# int32 count accumulators are exact only while a group can hold fewer
# than 2**31 rows; above that the packed count dtype widens to int64
COUNT_I32_MAX_ROWS = (1 << 31) - 1


def count_pack_dtype(n_rows: int) -> torch.dtype:
    """Accumulator dtype for packed int counts: int32 while no group can
    reach 2**31 rows, int64 beyond."""
    return torch.int32 if n_rows <= COUNT_I32_MAX_ROWS else torch.int64


def resolve_strategy(requested: str, num_segments: int) -> str:
    """Pick the fused strategy for one accumulator family: unroll for a
    handful of segments, scatter beyond (explicit requests honored, with
    unroll degrading to scatter past UNROLL_MAX_SEGMENTS and matmul, not
    ported, running scatter)."""
    if requested not in STRATEGIES or requested == "matmul":
        requested = "auto"
    if requested == "unroll" and num_segments > UNROLL_MAX_SEGMENTS:
        requested = "scatter"
    if requested != "auto":
        return requested
    return "unroll" if num_segments <= CPU_UNROLL_MAX_SEGMENTS \
        else "scatter"


def _pack(cols) -> torch.Tensor:
    if len(cols) == 1:
        return cols[0][:, None]
    return torch.stack(cols, dim=1)


def packed_sum(cols, gidx: torch.Tensor, num_segments: int,
               strategy: str) -> torch.Tensor:
    """Fused segmented SUM of a family's columns (list of [N] tensors)
    -> [num_segments, S].  Rows must already be masked into the additive
    identity (0); rows whose gidx is num_segments (the executor's
    overflow segment) are dropped."""
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
    out = torch.zeros((num_segments + 1, packed.shape[1]),
                      dtype=packed.dtype, device=packed.device)
    out.index_add_(0, gidx.long(), packed)
    return out[:num_segments]


def packed_minmax(kind: str, cols, gidx: torch.Tensor, num_segments: int,
                  strategy: str) -> torch.Tensor:
    """Fused segmented MIN/MAX of a family's columns (list of [N]
    tensors).  Rows must already be masked to the identity filler;
    empty segments yield that filler."""
    fill = extreme_of(cols[0].dtype, kind == "min", cols[0].device)
    if strategy == "unroll" and num_segments <= UNROLL_MAX_SEGMENTS:
        op = torch.amin if kind == "min" else torch.amax
        outs = []
        for k in range(num_segments):
            m = gidx == k
            outs.append(torch.stack([op(torch.where(m, c, fill))
                                     for c in cols]))
        return torch.stack(outs)
    packed = _pack(cols)
    out = torch.full((num_segments + 1, packed.shape[1]), fill.item(),
                     dtype=packed.dtype, device=packed.device)
    idx = gidx.long()[:, None].expand_as(packed)
    out.scatter_reduce_(0, idx, packed,
                        "amin" if kind == "min" else "amax",
                        include_self=True)
    return out[:num_segments]


def extreme_of(dtype: torch.dtype, positive: bool,
               device=None) -> torch.Tensor:
    """Identity filler for min (positive) / max as a 0-dim tensor."""
    if dtype.is_floating_point:
        v = float("inf") if positive else float("-inf")
    else:
        info = torch.iinfo(dtype)
        v = info.max if positive else info.min
    return torch.tensor(v, dtype=dtype, device=device)
