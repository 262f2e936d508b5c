"""Compressed-domain aggregate primitives: SUM in DICTIONARY space and
SUM/COUNT in RUN space.

Port of snappydata_tpu/ops/code_agg.py.  A SUM over a dictionary-encoded
column equals sum_c count[c] * dict[c], so the O(N) work touches only the
small integer codes (one `index_add_` of 0/1 weights into (group, batch,
code) cells) and an O(G * B * D) contraction with the per-batch
dictionary stack replaces N value gathers.  RLE goes further: with a
per-run boolean mask the filter and the reduction are both O(runs)
arithmetic over (value, length) pairs.  Accumulation is float64
throughout, like the packed fsum family; exact int64 accumulators must
not use these.
"""

from __future__ import annotations

import torch

# static cell budget for the (group, batch, code) space: past this the
# scatter output outweighs what the lane saves
DICT_SPACE_MAX_CELLS = 1 << 22


def dict_space_cells(nseg: int, codes_shape, dicts_shape) -> int:
    """Cell count of the joint (group, batch, code) space."""
    return int(nseg) * int(codes_shape[0]) * int(dicts_shape[1])


def dict_space_sum(codes: torch.Tensor, dicts: torch.Tensor,
                   gidx: torch.Tensor, w: torch.Tensor,
                   nseg: int) -> torch.Tensor:
    """SUM over a VALUE_DICT column in dictionary space.

    codes: [B, cap] uint8/uint16 plate codes; dicts: [B, Dp] per-batch
    dictionaries; gidx: [N] int group index with invalid rows already
    pointing at the overflow segment; w: [N] bool row weights (valid &
    not-null).  Returns [nseg] float64 group sums."""
    b, cap = codes.shape
    dp = dicts.shape[1]
    code = codes.reshape(-1).long()
    batch = torch.arange(b * cap, device=codes.device) // cap
    joint = (gidx.long() * b + batch) * dp + code
    counts = torch.zeros(nseg * b * dp, dtype=torch.float64,
                         device=codes.device)
    counts.index_add_(0, joint, w.to(torch.float64))
    return torch.einsum("gbd,bd->g", counts.view(nseg, b, dp),
                        dicts.to(torch.float64))


def run_space_sum_count(values: torch.Tensor, ends: torch.Tensor,
                        run_mask: torch.Tensor):
    """Global SUM + COUNT over an RLE plate in run space.

    values / ends: [B, R] run values and cumulative end offsets;
    run_mask: [B, R] bool per-run survivors (the whole filter conjunction
    reduced in run space — the caller's alignment proof).  Returns (total
    float64 0-dim, count int64 0-dim): count = sum(len * mask), total =
    sum(value * len * mask).  Padded runs repeat the last end, so their
    length is exactly 0 whatever their mask bit."""
    from snappydata_tpu_torch.storage.device_decode import (
        RlePlate, rle_masked_sum_count)

    return rle_masked_sum_count(RlePlate(values, ends), run_mask)
