"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where no GPU is present.  On a machine with one,
`python -m pytest tests/test_torch_cuda.py -q` runs them; the file imports
neither JAX nor the JAX package, so it also runs where those are absent.
Tolerances: compensated sums within rel 2e-7 of each other on same-sign
data and 1e-6 * sum(|v|) per group where signs mix (the two sum in other
orders); counts and min/max exact.
"""

import numpy as np
import pytest
import torch

from snappydata_tpu_torch.ops import group_reduce as gr
from snappydata_tpu_torch.ops.kahan_reduce import (masked_kahan_sum,
                                                   masked_kahan_sum_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# offset 1 starts every input one element into its buffer: the kernels'
# wide loads are then misaligned and they must read row by row
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kahan_matches_plain(cuda_device, offset):
    rng = np.random.default_rng(7)
    n = 3_000_001
    v = (rng.random(n + offset) * 2e4).astype(np.float32)
    m = rng.random(n + offset) < 0.6
    dv = _t(v).to(cuda_device)[offset:]
    dm = _t(m).to(cuda_device)[offset:]
    before = masked_kahan_sum.launches
    got = float(masked_kahan_sum(dv, dm))
    assert masked_kahan_sum.launches == before + 1
    plain = float(masked_kahan_sum_plain(_t(v[offset:]), _t(m[offset:])))
    exact = float(v[offset:].astype(np.float64)[m[offset:]].sum())
    assert abs(got - exact) / exact <= 1e-7
    assert abs(got - plain) / exact <= 2e-7


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_grouped_matches_plain(cuda_device, offset):
    rng = np.random.default_rng(8)
    n = 1_000_003
    G = 9
    gidx = rng.integers(0, G, n + offset).astype(np.int32)
    v = (rng.random(n + offset) * 100 - 50).astype(np.float32)
    m = rng.random(n + offset) < 0.9
    dg = _t(gidx).to(cuda_device)[offset:]
    dv = _t(v).to(cuda_device)[offset:]
    dm = _t(m).to(cuda_device)[offset:]
    # the slots share one mask and one value column, as Q1's do
    dev_ops = [("sum", dv, dm), ("count", None, dm), ("min", dv, dm),
               ("max", dv, dm)]
    before = gr.grouped_reduce.launches
    got = gr.grouped_reduce(dev_ops, dg, G)
    assert gr.grouped_reduce.launches == before + 1
    gidx, v, m = gidx[offset:], v[offset:], m[offset:]
    hv, hm = _t(v), _t(m)
    plain = gr.grouped_reduce_plain(
        [("sum", hv, hm), ("count", None, hm), ("min", hv, hm),
         ("max", hv, hm)], _t(gidx), G)
    for g in range(G):
        sel = (gidx == g) & m
        bound = 1e-6 * np.abs(v.astype(np.float64)[sel]).sum()
        assert abs(float(got[0][g]) - float(plain[0][g])) <= bound
        assert int(got[1][g]) == int(plain[1][g]) == int(sel.sum())
        assert float(got[2][g]) == float(plain[2][g]) == v[sel].min()
        assert float(got[3][g]) == float(plain[3][g]) == v[sel].max()
