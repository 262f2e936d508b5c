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
from snappydata_tpu_torch.ops import kahan_reduce as kr
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


def _code_inputs(rng, B, cap, code_dtype, D):
    codes_q = rng.integers(0, D, (B, cap)).astype(code_dtype)
    codes_d = rng.integers(0, D, (B, cap)).astype(code_dtype)
    ship = rng.integers(8000, 9500, (B, cap)).astype(np.int32)
    price = (rng.random((B, cap)) * 1e4).astype(np.float32)
    valid = rng.random((B, cap)) < 0.9
    valid[-1] = False                       # a padded batch
    dicts = np.sort(rng.random((B, D)), axis=1).astype(np.float32)
    dicts[-1] = 0.0
    qhi = rng.integers(0, D + 1, B).astype(np.int32)
    dlo = rng.integers(0, D // 2, B).astype(np.int32)
    dhi = (dlo + rng.integers(0, D // 2, B)).astype(np.int32)
    qhi[-1] = dlo[-1] = dhi[-1] = 0
    return codes_q, codes_d, ship, price, valid, dicts, qhi, dlo, dhi


# cap 1000 is not a multiple of 128 (nor of the TPU block); cap 1001 is
# not a multiple of 4, so the kernels' four-row loads are off
@pytest.mark.cuda
@pytest.mark.parametrize("code_dtype,D,cap", [(np.uint8, 16, 4096),
                                              (np.uint8, 200, 1001),
                                              (np.uint16, 3000, 1000)])
def test_cuda_code_filter_sum_matches_plain(cuda_device, code_dtype, D,
                                            cap):
    rng = np.random.default_rng(9)
    host = _code_inputs(rng, 5, cap, code_dtype, D)
    cq, cd, ship, price, valid, dicts, qhi, dlo, dhi = [_t(a) for a in host]
    args = (cq, cd, ship, price, valid, dicts, qhi, dlo, dhi, 8500, 9200)
    dev_args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor)
                     else a for a in args)
    before = kr.fused_code_filter_sum.launches
    got_s, got_n = kr.fused_code_filter_sum(*dev_args)
    assert kr.fused_code_filter_sum.launches == before + 1
    plain_s, plain_n = kr.fused_code_filter_sum_plain(*args)
    assert int(got_n) == int(plain_n) > 0
    prod = (price.double() * kr.decode_rows(cd, dicts).double()).abs()
    ok = kr.code_filter_mask(cq, cd, ship, valid, qhi, dlo, dhi, 8500, 9200)
    bound = 1e-6 * float(prod[ok].sum())
    assert abs(float(got_s) - float(plain_s)) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("G,cap", [(1, 4096), (6, 1000), (64, 1001)])
def test_cuda_grouped_code_reduce_matches_plain(cuda_device, G, cap):
    rng = np.random.default_rng(10)
    B, D = 4, 16
    gidx = rng.integers(0, G, (B, cap)).astype(np.int32)
    mask = rng.random((B, cap)) < 0.8
    plain = (rng.random((B, cap)) * 1e4).astype(np.float32)
    c8 = rng.integers(0, D, (B, cap)).astype(np.uint8)
    c16 = rng.integers(0, 300, (B, cap)).astype(np.uint16)
    d8 = rng.random((B, D)).astype(np.float32)
    d16 = rng.random((B, 256)).astype(np.float32)   # codes past 255 -> 0

    def slots(t):
        return [("count",),
                ("sum", t(plain), []),
                ("sum", None, [(t(c8), t(d8))]),
                ("sum", t(plain), [(t(c8), t(d8)), (t(c16), t(d16))])]

    hosts = {}

    def keep(a):                 # one tensor per array, so dedup fires
        return hosts.setdefault(id(a), _t(a).to(cuda_device))

    before = gr.grouped_code_reduce.launches
    got = gr.grouped_code_reduce(keep(gidx), keep(mask), slots(keep), G)
    assert gr.grouped_code_reduce.launches == before + 1
    want = gr.grouped_code_reduce_plain(_t(gidx), _t(mask), slots(_t), G)
    assert torch.equal(got[0].cpu(), want[0])
    for k in range(1, 4):
        v = gr.slot_values(slots(_t)[k], gidx.shape, "cpu").double().abs()
        scale = torch.zeros(G, dtype=torch.float64).index_add_(
            0, _t(gidx).reshape(-1).long(),
            torch.where(_t(mask).reshape(-1), v.reshape(-1), 0.0))
        diff = (got[k].cpu() - want[k]).abs()
        assert bool((diff <= 1e-6 * scale + 1e-9).all()), (k, diff, scale)
