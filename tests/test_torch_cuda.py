"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where no GPU is present.  On a machine with one,
`python -m pytest tests/test_torch_cuda.py -q` runs them; the file imports
neither JAX nor the JAX package, so it also runs where those are absent.
Tolerances: compensated sums within rel 2e-7 of each other on same-sign
data and 1e-6 * sum(|v|) per group where signs mix (the two sum in other
orders); counts and min/max exact.
"""

import time

import numpy as np
import pytest
import torch

from snappydata_tpu_torch import config
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


# n 4097 is 4k + 1; the views start `offset` rows into buffers the
# allocator aligns, so the kernel peels (4 - offset) % 4 rows and then
# runs its float4 loop.  Mixed signs: within 1e-6 * sum(|v|) of the plain
# version (the two add their chains in other orders).
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 1023, 4097, 4_194_304])
def test_cuda_kahan_sizes_and_offsets(cuda_device, n, offset):
    rng = np.random.default_rng(11 + n + offset)
    v = (rng.random(n + offset) * 200 - 100).astype(np.float32)
    m = rng.random(n + offset) < 0.6
    dv = _t(v).to(cuda_device)[offset:]
    dm = _t(m).to(cuda_device)[offset:]
    before = masked_kahan_sum.launches
    got = masked_kahan_sum(dv, dm)
    assert masked_kahan_sum.launches == before + 1
    assert got.dtype == torch.float64 and got.dim() == 0
    cfg = masked_kahan_sum.config
    assert cfg["vector"] and cfg["peeled"] == min(n, (4 - offset) % 4)
    assert 1 <= cfg["blocks"] <= cfg["blocks_per_sm"] * \
        torch.cuda.get_device_properties(cuda_device).multi_processor_count
    v, m = v[offset:], m[offset:]
    plain = float(masked_kahan_sum_plain(_t(v), _t(m)))
    bound = 1e-6 * float(np.abs(v.astype(np.float64)[m]).sum())
    assert abs(float(got) - plain) <= bound
    if n == 0:
        assert float(got) == 0.0


@pytest.mark.cuda
def test_cuda_kahan_offsets_that_disagree_read_row_by_row(cuda_device):
    rng = np.random.default_rng(12)
    n = 100_003
    v = (rng.random(n + 1) * 2e4).astype(np.float32)
    m = rng.random(n + 2) < 0.6
    dv = _t(v).to(cuda_device)[1:]
    dm = _t(m).to(cuda_device)[2:]
    got = float(masked_kahan_sum(dv, dm))
    assert not masked_kahan_sum.config["vector"]
    exact = float(v[1:].astype(np.float64)[m[2:]].sum())
    assert abs(got - exact) / exact <= 1e-7


@pytest.mark.cuda
def test_cuda_kahan_all_false_mask_is_exact_zero(cuda_device):
    v = torch.full((4_194_307,), 3.25, device=cuda_device)
    m = torch.zeros(v.shape, dtype=torch.bool, device=cuda_device)
    assert float(masked_kahan_sum(v, m)) == 0.0
    assert float(masked_kahan_sum(v[:0], m[:0])) == 0.0


@pytest.mark.cuda
def test_cuda_kahan_repeated_calls_bit_identical(cuda_device):
    rng = np.random.default_rng(13)
    v = _t((rng.random(8_388_611) * 200 - 100).astype(np.float32))
    m = _t(rng.random(8_388_611) < 0.5)
    dv, dm = v.to(cuda_device), m.to(cuda_device)
    outs = [masked_kahan_sum(dv, dm) for _ in range(5)]
    vals = [float(o) for o in outs]
    assert len(set(vals)) == 1, vals


@pytest.mark.cuda
def test_cuda_kahan_interleaved_on_two_streams(cuda_device):
    """Launches on two streams keep their own block partials and ticket
    counters: each stream's answers equal a default-stream call's."""
    rng = np.random.default_rng(14)
    ins = []
    for n in (4_194_304, 3_000_001):
        v = _t((rng.random(n) * 2e4).astype(np.float32)).to(cuda_device)
        m = _t(rng.random(n) < 0.5).to(cuda_device)
        ins.append((v, m, float(masked_kahan_sum(v, m))))
    streams = [torch.cuda.Stream(cuda_device) for _ in ins]
    torch.cuda.synchronize()
    outs = []
    for _ in range(8):
        for st, (v, m, _want) in zip(streams, ins):
            with torch.cuda.stream(st):
                outs.append(masked_kahan_sum(v, m))
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        assert float(o) == ins[i % 2][2]


@pytest.mark.cuda
def test_cuda_kahan_one_device_kernel_per_call(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    v = torch.rand(4_194_304, device=cuda_device)
    m = v < 0.5
    masked_kahan_sum(v, m)
    torch.cuda.synchronize()
    before = masked_kahan_sum.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler drops the device records of about the first
        # millisecond of a session: spin kernels take that loss and are
        # left out below
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.02:
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        time.sleep(0.5)
        for _ in range(5):
            masked_kahan_sum(v, m)
        torch.cuda.synchronize()
    assert masked_kahan_sum.launches == before + 5
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "spin_kernel" not in e.key]
    assert [(("kahan_sum_kernel" in e.key), e.count) for e in dev] == \
        [(True, 5)], [(e.key, e.count) for e in dev]


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


def _same(a, b):
    """Equal, with NaN equal to NaN (min/max propagate it)."""
    a, b = a.cpu(), b.cpu()
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _check_grouped(got, ops_host, gidx, G):
    """The kernel's results against the plain version run on every op
    (no dedup): counts and min/max exact, sums within 1e-6 * sum(|v|)."""
    want = gr.grouped_reduce_plain(ops_host, _t(gidx), G)
    assert len(got) == len(want)
    for (k, v, m), a, b in zip(ops_host, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if k != "sum":
            assert _same(a, b), (k, a, b)
            continue
        scale = torch.zeros(G, dtype=torch.float64).index_add_(
            0, _t(gidx).long(), torch.where(m, v.double().abs(), 0.0))
        assert bool(((a.cpu() - b).abs() <= 1e-6 * scale + 1e-9).all())


# duplicated ops share one chain; every caller's slot gets its own
# result.  Offset 1 misaligns every input, n is ragged
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_grouped_duplicate_ops(cuda_device, offset):
    rng = np.random.default_rng(11)
    n, G = 2_000_003, 9
    gidx = rng.integers(0, G, n + offset).astype(np.int32)
    v1 = (rng.random(n + offset) * 2e4).astype(np.float32)
    v2 = (rng.random(n + offset) * 100 - 50).astype(np.float32)
    m1 = rng.random(n + offset) < 0.9
    m2 = rng.random(n + offset) < 0.5
    dev = {}
    host = {}
    for name, a in (("g", gidx), ("v1", v1), ("v2", v2), ("m1", m1),
                    ("m2", m2)):
        dev[name] = _t(a).to(cuda_device)[offset:]
        host[name] = _t(a[offset:])

    def ops(t):
        return [("sum", t["v1"], t["m1"]), ("count", None, t["m1"]),
                ("sum", t["v2"], t["m2"]), ("sum", t["v1"], t["m1"]),
                ("max", t["v2"], t["m1"]), ("count", None, t["m1"]),
                ("min", t["v2"], t["m2"]), ("max", t["v2"], t["m1"]),
                ("sum", t["v1"], t["m2"]), ("count", None, t["m2"])]

    before = gr.grouped_reduce.launches
    got = gr.grouped_reduce(ops(dev), dev["g"], G)
    assert gr.grouped_reduce.launches == before + 1
    assert gr.grouped_reduce.config["ops"] == 10
    assert gr.grouped_reduce.config["chains"] == 7
    _check_grouped(got, ops(host), gidx[offset:], G)


# every row in one group: the four rows of each step all hit the same
# words, so the rows of a step must update in order
@pytest.mark.cuda
def test_cuda_grouped_every_row_in_one_group(cuda_device):
    rng = np.random.default_rng(12)
    n, G = 1_000_000, 9
    gidx = np.full(n, 4, dtype=np.int32)
    v = (rng.random(n) * 1e3).astype(np.float32)
    m = rng.random(n) < 0.8
    dg, dv, dm = (_t(a).to(cuda_device) for a in (gidx, v, m))
    got = gr.grouped_reduce([("sum", dv, dm), ("count", None, dm),
                             ("min", dv, dm), ("max", dv, dm)], dg, G)
    hv, hm = _t(v), _t(m)
    _check_grouped(got, [("sum", hv, hm), ("count", None, hm),
                         ("min", hv, hm), ("max", hv, hm)], gidx, G)
    assert int(got[1][4]) == int(m.sum())
    exact = float(v.astype(np.float64)[m].sum())
    assert abs(float(got[0][4]) - exact) <= 1e-7 * exact


# G = 64 with 3 sums and a count: 7 words * 64 groups * 128 threads *
# 4 B = 229,376 B, the largest layout under the 232,448-byte budget
@pytest.mark.cuda
def test_cuda_grouped_g64_at_the_smem_edge(cuda_device):
    rng = np.random.default_rng(13)
    n, G = 1_500_001, 64
    gidx = rng.integers(-1, G + 1, n).astype(np.int32)   # some outside
    vs = [(rng.random(n) * 10 - 5).astype(np.float32) for _ in range(3)]
    m = rng.random(n) < 0.7
    dg, dm = _t(gidx).to(cuda_device), _t(m).to(cuda_device)
    dvs = [_t(a).to(cuda_device) for a in vs]
    ops = [("sum", a, dm) for a in dvs] + [("count", None, dm)]
    got = gr.grouped_reduce(ops, dg, G)
    cfg = gr.grouped_reduce.config
    assert cfg["words"] == 7 and cfg["smem"] == 229_376
    assert cfg["smem"] <= gr.SMEM_BUDGET and cfg["blocks_per_sm"] >= 1
    hm = _t(m)
    inside = (gidx >= 0) & (gidx < G)
    # rows outside [0, G) count nowhere; the plain version never sees them
    host_ops = [("sum", _t(a), hm & _t(inside)) for a in vs] \
        + [("count", None, hm & _t(inside))]
    _check_grouped(got, host_ops, np.where(inside, gidx, 0), G)
    with pytest.raises(ValueError):
        gr.grouped_reduce(ops + [("sum", dm.float(), dm)], dg, G)


# NaN in a group's values: min and max propagate it, as torch does
@pytest.mark.cuda
def test_cuda_grouped_nan_minmax(cuda_device):
    rng = np.random.default_rng(14)
    n, G = 400_003, 5
    gidx = rng.integers(0, G, n).astype(np.int32)
    v = (rng.random(n) * 10).astype(np.float32)
    m = np.ones(n, dtype=bool)
    v[np.flatnonzero(gidx == 2)[::1000]] = np.nan
    v[np.flatnonzero(gidx == 3)[:1]] = np.nan
    dg, dv, dm = (_t(a).to(cuda_device) for a in (gidx, v, m))
    got = gr.grouped_reduce([("min", dv, dm), ("max", dv, dm),
                             ("count", None, dm)], dg, G)
    assert bool(torch.isnan(got[0][2])) and bool(torch.isnan(got[1][3]))
    assert not bool(torch.isnan(got[0][0]))
    hv, hm = _t(v), _t(m)
    _check_grouped(got, [("min", hv, hm), ("max", hv, hm),
                         ("count", None, hm)], gidx, G)


def _check_code(got, gidx, mask, slots_host, G):
    want = gr.grouped_code_reduce_plain(_t(gidx), _t(mask), slots_host, G)
    assert len(got) == len(want)
    for slot, a, b in zip(slots_host, got, want):
        assert a.dtype == b.dtype
        if slot[0] == "count":
            assert torch.equal(a.cpu(), b)
            continue
        v = gr.slot_values(slot, gidx.shape, "cpu").double().abs()
        g = _t(gidx).reshape(-1).long()
        keep = _t(mask).reshape(-1) & (g >= 0) & (g < G)
        scale = torch.zeros(G, dtype=torch.float64).index_add_(
            0, g.clamp(0, G - 1), torch.where(keep, v.reshape(-1), 0.0))
        assert bool(((a.cpu() - b).abs() <= 1e-6 * scale + 1e-9).all())


def _code_case(rng, B, cap, G, D=16):
    gidx = rng.integers(0, G, (B, cap)).astype(np.int32)
    mask = rng.random((B, cap)) < 0.8
    plain = (rng.random((B, cap)) * 1e4).astype(np.float32)
    c8 = rng.integers(0, D, (B, cap)).astype(np.uint8)
    c16 = rng.integers(0, 300, (B, cap)).astype(np.uint16)
    d8 = rng.random((B, D)).astype(np.float32)
    d16 = rng.random((B, 256)).astype(np.float32)   # codes past 255 -> 0
    return gidx, mask, plain, c8, c16, d8, d16


def _code_slots(t, plain, c8, c16, d8, d16):
    return [("sum", t(plain), [(t(c8), t(d8))]), ("count",),
            ("sum", t(plain), [(t(c8), t(d8))]),
            ("sum", None, [(t(c16), t(d16))]), ("count",),
            ("sum", t(plain), [(t(c8), t(d8)), (t(c16), t(d16))])]


# duplicated slots, and B >> grid: 5000 batches of 64 (or 63, ragged)
# rows, so each block walks several batches and reloads dictionaries
@pytest.mark.cuda
@pytest.mark.parametrize("B,cap,G", [(5000, 64, 6), (5000, 63, 9),
                                     (3, 4096, 6)])
def test_cuda_code_duplicate_slots_and_many_batches(cuda_device, B, cap, G):
    rng = np.random.default_rng(15)
    gidx, mask, plain, c8, c16, d8, d16 = _code_case(rng, B, cap, G)
    hosts = {}

    def keep(a):                 # one tensor per array, so dedup fires
        return hosts.setdefault(id(a), _t(a).to(cuda_device))

    before = gr.grouped_code_reduce.launches
    got = gr.grouped_code_reduce(
        keep(gidx), keep(mask), _code_slots(keep, plain, c8, c16, d8, d16),
        G)
    assert gr.grouped_code_reduce.launches == before + 1
    cfg = gr.grouped_code_reduce.config
    assert (cfg["slots"], cfg["chains"]) == (6, 4)
    if B == 5000:
        assert cfg["tiles"] == B > cfg["blocks"]
    _check_code(got, gidx, mask, _code_slots(_t, plain, c8, c16, d8, d16),
                G)


# every row in one group; a few rows outside [0, G) count nowhere
@pytest.mark.cuda
def test_cuda_code_every_row_in_one_group(cuda_device):
    rng = np.random.default_rng(16)
    B, cap, G = 8, 65536, 6
    gidx, mask, plain, c8, c16, d8, d16 = _code_case(rng, B, cap, G)
    gidx[:] = 5
    gidx[0, :100] = 6
    gidx[1, :100] = -1
    hosts = {}

    def keep(a):
        return hosts.setdefault(id(a), _t(a).to(cuda_device))

    got = gr.grouped_code_reduce(
        keep(gidx), keep(mask), _code_slots(keep, plain, c8, c16, d8, d16),
        G)
    inside = mask & (gidx >= 0) & (gidx < G)
    assert int(got[1][5]) == int(inside.sum())
    _check_code(got, np.where(inside, gidx, 0), inside,
                _code_slots(_t, plain, c8, c16, d8, d16), G)


# Q1's slot order (a count, qty, price, price * (1 - disc), price *
# (1 - disc) * (1 + tax)), on the four-row path (cap 4096) and the row
# path (63)
@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4096, 63])
def test_cuda_code_q1_slot_order(cuda_device, cap):
    rng = np.random.default_rng(17)
    gidx, mask, plain, c8, c16, d8, d16 = _code_case(rng, 6, cap, 6)
    hosts = {}

    def keep(a):
        return hosts.setdefault(id(a), _t(a).to(cuda_device))

    def slots(t):
        return [("count",), ("sum", None, [(t(c8), t(d8))]),
                ("sum", t(plain), []), ("sum", t(plain), [(t(c8), t(d8))]),
                ("sum", t(plain), [(t(c8), t(d8)), (t(c16), t(d16))])]

    got = gr.grouped_code_reduce(keep(gidx), keep(mask), slots(keep), 6)
    _check_code(got, gidx, mask, slots(_t), 6)


# --- the device join engine on the card ------------------------------------

JOIN_QUERIES = [
    "Q3C",
    "SELECT o_orderdate, count(*), sum(l_extendedprice) FROM orders "
    "JOIN lineitem ON o_orderkey = l_orderkey GROUP BY o_orderdate "
    "ORDER BY o_orderdate",
]


@pytest.mark.cuda
@pytest.mark.parametrize("query", JOIN_QUERIES, ids=["q3c", "orderdate"])
def test_cuda_join_matches_cpu_session(cuda_device, query):
    """TPC-H Q3C (a one-to-many LEFT JOIN) and a generic-key join on the
    card, with the grouped kernel on, against the same query in a CPU
    session over the same rows: group keys and counts exact, float32-plate
    sums within rel 5e-5, and no host fallback on the card."""
    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.utils import tpch

    sql = tpch.Q3C if query == "Q3C" else query
    props = config.global_properties()
    saved = props.pallas_group_reduce
    props.pallas_group_reduce = True
    try:
        rows = {}
        for dev in ("cpu", cuda_device):
            s = SnappySession(catalog=Catalog(), device=dev)
            tpch.load_tpch(s, sf=0.05, seed=4)
            fb = global_registry().counter("host_fallbacks")
            jfb = global_registry().counter("join_host_fallbacks")
            rows[str(dev)] = s.sql(sql).rows()
            assert global_registry().counter("host_fallbacks") == fb
            assert global_registry().counter("join_host_fallbacks") == jfb
    finally:
        props.pallas_group_reduce = saved
    got, want = rows[str(cuda_device)], rows["cpu"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert g[2] == pytest.approx(w[2], rel=5e-5)


# --- the tiled lane and its prefetcher on the card -------------------------

def _tiled_session(dev, n, batch_rows, seed=3):
    """A session on `dev` with one column table of `n` rows cut into
    `batch_rows`-row batches (string key, f32/f64 value, int, date)."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    rng = np.random.default_rng(seed)
    s = SnappySession(catalog=Catalog(), device=dev)
    s.sql("CREATE TABLE tl (k STRING, v DOUBLE, w BIGINT, d DATE) "
          f"USING column OPTIONS (column_batch_rows '{batch_rows}')")
    s.insert_arrays("tl", [
        rng.choice(np.array(["a", "b", "c", "d", "e"], dtype=object), n),
        np.round(rng.uniform(0, 1000, n), 2),
        rng.integers(0, 1000, n, dtype=np.int64),
        rng.integers(8000, 11000, n).astype(np.int32)])
    data = s.catalog.describe("tl").data
    if data.snapshot().row_count:
        data.force_rollover()
    return s


TILED_Q = ("SELECT k, count(*), sum(v), min(w), max(w) FROM tl "
           "WHERE d >= DATE '1995-01-01' GROUP BY k ORDER BY k")


@pytest.mark.cuda
def test_cuda_prefetch_uploads_on_its_stream_in_order(cuda_device):
    """The worker uploads each look-ahead window on its own stream from
    pinned memory; the consumer's stream waits on the window's event, and
    the plates are marked used on the consumer's stream.  A window read
    right after `await_window` equals the same window bound synchronously,
    and the whole tiled answer equals the untiled one, with no worker
    death."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage import device as dmod
    from snappydata_tpu_torch.storage.prefetch import TilePrefetcher

    s = _tiled_session(cuda_device, 1 << 18, 8192)
    data = s.catalog.describe("tl").data
    man = data.snapshot()
    units = dmod.scan_unit_count(data, man)
    assert units == 32
    cols = [1, 2, 3]
    pf = TilePrefetcher(data, man, units, 4, 1, cuda_device)
    with config.device_scope(cuda_device):
        try:
            for lo in range(0, units, 4):
                pf.await_window(lo)
                with dmod.scan_window(data, lo, lo + 4, man, tile_units=4):
                    # decoded plates (code_ok=False), which the worker
                    # mirrors from window 0's cache entry
                    dt = dmod.build_device_table(data, cols, cuda_device,
                                                 code_ok=False)
                    got = [float(dt.columns[c].double().sum())
                           for c in cols]
                pf.advance(lo)
                # the same window's values straight from the host batches
                with dmod.scan_window(data, lo, lo + 4, man, tile_units=4):
                    _m, views, chunks = dmod.host_scan_units(data)
                assert len(views) == 4 and not chunks
                for c, g in zip(cols, got):
                    dt = data.schema.fields[c].dtype.device_dtype()
                    want = sum(float(v.decoded_column(c).astype(dt)
                                     .astype(np.float64).sum())
                               for v in views)
                    assert g == pytest.approx(want, rel=1e-12), (lo, c)
        finally:
            pf.close()
    assert not pf.dead()
    windowed = [k for k in data._device_cache if k[2] is not None]
    assert windowed == []

    reg = global_registry()
    props = config.global_properties()
    saved_tile = props.scan_tile_bytes
    try:
        untiled = s.sql(TILED_Q).rows()
        props.scan_tile_bytes = 3 * 8192 * 24
        w0 = reg.counter("prefetch_windows_warmed")
        d0 = reg.counter("prefetch_worker_deaths")
        t0 = reg.counter("scan_tiles")
        tiled = s.sql(TILED_Q).rows()
    finally:
        props.scan_tile_bytes = saved_tile
    tiles = reg.counter("scan_tiles") - t0
    assert tiles > 2
    assert reg.counter("prefetch_windows_warmed") - w0 == tiles - 1
    assert reg.counter("prefetch_worker_deaths") == d0
    assert len(tiled) == len(untiled)
    for a, b in zip(tiled, untiled):
        assert (a[0], a[1], a[3], a[4]) == (b[0], b[1], b[3], b[4])
        assert a[2] == pytest.approx(b[2], rel=1e-6)


@pytest.mark.cuda
def test_cuda_tiles_stay_within_the_memory_bound(cuda_device):
    """A tiled pass over a table ten times its tile budget allocates at
    most (tier_prefetch_depth + 2) tiles plus 64 MiB above what was
    resident before it, and merges on the device."""
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import global_registry

    s = _tiled_session(cuda_device, 1 << 22, 1 << 16)
    data = s.catalog.describe("tl").data
    props = config.global_properties()
    saved = props.scan_tile_bytes
    reg = global_registry()
    # k, v, w, d at 5 + 5 + 9 + 5 bytes per row plus validity: 25 B/row
    budget = (1 << 22) * 25 // 10
    try:
        props.scan_tile_bytes = budget
        data._device_cache.clear()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        h0 = reg.counter("scan_tile_host_merges")
        d0 = reg.counter("scan_tile_device_merges")
        rows = s.sql(TILED_Q).rows()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
    finally:
        props.scan_tile_bytes = saved
    depth = int(props.tier_prefetch_depth)
    assert len(rows) == 5
    assert reg.counter("scan_tile_host_merges") == h0
    assert reg.counter("scan_tile_device_merges") > d0
    assert peak <= (depth + 2) * budget + (64 << 20), (peak, budget)


TILED_SUM_Q = ("SELECT sum(v), count(*) FROM tl "
               "WHERE d >= DATE '1995-01-01'")


@pytest.mark.cuda
def test_cuda_tiled_global_sum_launches_kahan_per_tile(cuda_device):
    """The prefetch worker binds its windows under the session's device
    policy: float32 value plates on the card, as the consumer binds them
    (a worker outside the session's device scope binds float64 plates,
    and the Kahan kernel, which takes float32 only, then never runs).  A
    tiled global SUM over a DOUBLE column launches `masked_kahan_sum`
    once per tile, merges on the device, and equals the untiled answer."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage import device as dmod
    from snappydata_tpu_torch.storage.prefetch import TilePrefetcher

    s = _tiled_session(cuda_device, 1 << 18, 8192)
    data = s.catalog.describe("tl").data
    man = data.snapshot()
    units = dmod.scan_unit_count(data, man)
    pf = TilePrefetcher(data, man, units, 4, 1, cuda_device)
    with config.device_scope(cuda_device):
        try:
            for lo in range(0, units, 4):
                pf.await_window(lo)
                with dmod.scan_window(data, lo, lo + 4, man, tile_units=4):
                    dt = dmod.build_device_table(data, [1, 3], cuda_device,
                                                 code_ok=False)
                    assert dt.columns[1].dtype == torch.float32, lo
                pf.advance(lo)
        finally:
            pf.close()
    assert not pf.dead()

    reg = global_registry()
    props = config.global_properties()
    saved = (props.scan_tile_bytes, props.pallas_reduce)
    try:
        props.pallas_reduce = True
        untiled = s.sql(TILED_SUM_Q).rows()
        props.scan_tile_bytes = 3 * 8192 * 24
        t0 = reg.counter("scan_tiles")
        d0 = reg.counter("scan_tile_device_merges")
        h0 = reg.counter("scan_tile_host_merges")
        kr.masked_kahan_sum.launches = 0
        tiled = s.sql(TILED_SUM_Q).rows()
        launches = kr.masked_kahan_sum.launches
    finally:
        props.scan_tile_bytes, props.pallas_reduce = saved
    tiles = reg.counter("scan_tiles") - t0
    assert tiles > 2
    assert launches == tiles
    assert reg.counter("scan_tile_device_merges") > d0
    assert reg.counter("scan_tile_host_merges") == h0
    assert tiled[0][1] == untiled[0][1]
    assert tiled[0][0] == pytest.approx(untiled[0][0], rel=1e-6)


# --- subqueries and functions on the card ----------------------------------

def _sub_sessions(cuda_device):
    """The same tables in a CUDA session and a CPU session: a(k, g) with a
    string key, b(y, w) with a DOUBLE of distinct values (no value
    dictionary), t(d, s, x) with dates, ship modes and quantities."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    rng = np.random.default_rng(12)
    n = 200_000
    a = [np.arange(n, dtype=np.int64),
         np.array(["p", "q", "r", "s"], dtype=object)[
             rng.integers(0, 4, n)]]
    b = [rng.integers(0, 2 * n, n).astype(np.int64), rng.random(n)]
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"], dtype=object)
    t = [rng.integers(8000, 10500, n).astype(np.int32),
         modes[rng.integers(0, 7, n)],
         rng.integers(1, 51, n).astype(np.float64)]
    out = {}
    for dev in ("cpu", cuda_device):
        s = SnappySession(catalog=Catalog(), device=dev)
        s.sql("CREATE TABLE a (k BIGINT, g STRING) USING column")
        s.sql("CREATE TABLE b (y BIGINT, w DOUBLE) USING column")
        s.sql("CREATE TABLE t (d DATE, s STRING, x DOUBLE) USING column")
        s.insert_arrays("a", a)
        s.insert_arrays("b", b)
        s.insert_arrays("t", t)
        out[str(dev)] = s
    return out["cpu"], out[str(cuda_device)]


def _on_card(cpu, card, sql, counter):
    """Rows of `sql` on the card, equal to the CPU session's, with no host
    fallback and `counter` (a kernel wrapper) launched."""
    from snappydata_tpu_torch.observability.metrics import global_registry

    want = cpu.sql(sql).rows()
    fb = global_registry().counter("host_fallbacks")
    counter.launches = 0
    got = card.sql(sql).rows()
    assert global_registry().counter("host_fallbacks") == fb, sql
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        assert g[-1] == pytest.approx(w[-1], rel=1e-6)
    return counter.launches


@pytest.mark.cuda
def test_cuda_exists_and_large_in_list_stay_on_device(cuda_device):
    """EXISTS becomes a semi join and a 500-literal IN list the sorted
    probe (fault C2): both stay on the card, and their GROUP BY over a
    string key launches the grouped kernel."""
    from snappydata_tpu_torch import config

    cpu, card = _sub_sessions(cuda_device)
    props = config.global_properties()
    saved = props.pallas_group_reduce
    props.pallas_group_reduce = True
    vals = ",".join(str(v) for v in range(0, 200_000, 401))
    try:
        for sql in ("SELECT g, count(*) FROM a WHERE EXISTS (SELECT 1 "
                    "FROM b WHERE b.y = a.k AND b.w > 0.5) GROUP BY g "
                    "ORDER BY g",
                    f"SELECT g, count(*) FROM a WHERE k IN ({vals}) "
                    "GROUP BY g ORDER BY g",
                    "SELECT g, count(*) FROM a WHERE k IN (SELECT y FROM b "
                    "WHERE w < 0.01) GROUP BY g ORDER BY g"):
            assert _on_card(cpu, card, sql, gr.grouped_reduce) >= 1, sql
    finally:
        props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_scalar_subquery_avg_launches_kahan(cuda_device):
    from snappydata_tpu_torch import config

    cpu, card = _sub_sessions(cuda_device)
    props = config.global_properties()
    saved = props.pallas_reduce
    props.pallas_reduce = True
    try:
        launches = _on_card(cpu, card,
                            "SELECT count(*), sum(w) FROM b "
                            "WHERE w > (SELECT avg(w) FROM b)",
                            kr.masked_kahan_sum)
    finally:
        props.pallas_reduce = saved
    assert launches >= 1


@pytest.mark.cuda
def test_cuda_date_and_string_functions_group_on_device(cuda_device):
    """year() and substr() as GROUP BY keys and abs() in a sum stay on the
    card (the date part on the generic key lane, the prefix as a derived
    dictionary)."""
    cpu, card = _sub_sessions(cuda_device)
    _on_card(cpu, card,
             "SELECT year(d), substr(s, 1, 2), count(*), sum(abs(x - 25)) "
             "FROM t GROUP BY 1, 2 ORDER BY 1, 2", gr.grouped_reduce)


# --- windows, mutations and MVCC pins on the card --------------------------

def _f32_cpu_policy():
    """The CPU session's plate policy set to the card's (float32 plates),
    so both sides round DOUBLE order keys and values alike."""
    from snappydata_tpu_torch import config

    props = config.global_properties()
    saved = props.decimal_as_float64
    props.decimal_as_float64 = False
    return props, saved


WINDOW_Q = ("SELECT id, row_number() OVER (PARTITION BY g ORDER BY o, id), "
            "rank() OVER (PARTITION BY g ORDER BY o), "
            "dense_rank() OVER (PARTITION BY g ORDER BY v DESC), "
            "sum(v) OVER (PARTITION BY g ORDER BY o), "
            "count(v) OVER (PARTITION BY g ORDER BY o), "
            "min(v) OVER (PARTITION BY g ORDER BY o), "
            "max(v) OVER (PARTITION BY g), "
            "lag(v) OVER (PARTITION BY g ORDER BY o, id), "
            "lead(o) OVER (PARTITION BY g ORDER BY o, id) "
            "FROM w WHERE o < 900 ORDER BY id")


@pytest.mark.cuda
def test_cuda_window_lowering_matches_cpu(cuda_device):
    """The device window lane on the card against the same query in a CPU
    session under float32 plates: ranks, counts and lag / lead exact,
    running sums rel 1e-6, no host fallback on the card."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry

    rng = np.random.default_rng(21)
    n = 300_000
    cols = [np.arange(n, dtype=np.int32),
            rng.integers(0, 5000, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32),
            np.round(rng.uniform(1, 1000, n), 2)]
    nulls = [None, None, None, rng.random(n) < 0.05]
    props, saved = _f32_cpu_policy()
    try:
        rows = {}
        for dev in ("cpu", cuda_device):
            s = SnappySession(catalog=Catalog(), device=dev)
            s.sql("CREATE TABLE w (id INT, g INT, o INT, v DOUBLE) "
                  "USING column")
            s.catalog.describe("w").data.insert_arrays(
                [c.copy() for c in cols], nulls=nulls)
            fb = global_registry().counter("host_fallbacks")
            rows[str(dev)] = s.sql(WINDOW_Q).rows()
            assert global_registry().counter("host_fallbacks") == fb
    finally:
        props.decimal_as_float64 = saved
    got, want = rows[str(cuda_device)], rows["cpu"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:4] == w[:4] and g[5] == w[5] and g[9] == w[9]
        for a, b in zip((g[4], g[6], g[7], g[8]), (w[4], w[6], w[7], w[8])):
            assert (a is None) == (b is None)
            if b is not None:
                assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.cuda
def test_cuda_q1_q6_after_delete_and_update_launch_both_kernels(cuda_device):
    """DELETE and UPDATE on lineitem, then Q1 and Q6 with both kernel
    lanes on: the card launches the grouped and the Kahan kernel (the
    delete mask in the valid plate, l_discount bound decoded with its
    delta) and answers as a CPU session under float32 plates."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.utils import tpch

    props, saved = _f32_cpu_policy()
    knobs = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = props.pallas_group_reduce = True
    try:
        rows = {}
        for dev in ("cpu", cuda_device):
            s = SnappySession(catalog=Catalog(), device=dev)
            tpch.load_tpch(s, sf=0.05, seed=4)
            s.sql("DELETE FROM lineitem WHERE l_quantity >= 49")
            s.sql("UPDATE lineitem SET l_discount = l_discount + 0.01 "
                  "WHERE l_shipdate >= DATE '1994-01-01' "
                  "AND l_discount < 0.10")
            c0 = global_registry().counter("compressed_fallback_deltas")
            gr.grouped_reduce.launches = 0
            kr.masked_kahan_sum.launches = 0
            rows[str(dev)] = (s.sql(tpch.Q1).rows(), s.sql(tpch.Q6).rows())
            if dev != "cpu":
                assert gr.grouped_reduce.launches >= 1
                assert kr.masked_kahan_sum.launches >= 1
                assert global_registry().counter(
                    "compressed_fallback_deltas") > c0
    finally:
        props.decimal_as_float64 = saved
        props.pallas_reduce, props.pallas_group_reduce = knobs
    for got, want in zip(rows[str(cuda_device)], rows["cpu"]):
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, (str, int)):
                    assert a == b
                else:
                    assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.cuda
def test_cuda_pinned_versions_keep_their_plates(cuda_device):
    """A version a pin holds keeps its device plates while newer versions
    bind (the same tensor objects serve the pinned re-read); once the pin
    is released, the next bind drops them."""
    import threading

    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.storage import mvcc

    s = SnappySession(catalog=Catalog(), device=cuda_device)
    s.sql("CREATE TABLE p (k BIGINT, v DOUBLE) USING column")
    s.insert_arrays("p", [np.arange(100_000, dtype=np.int64),
                          np.ones(100_000)])
    data = s.catalog.describe("p").data
    q = "SELECT count(*), sum(v) FROM p"

    def other_session():
        w = SnappySession(catalog=s.catalog, device=cuda_device)
        w.insert_arrays("p", [np.arange(10, dtype=np.int64), np.ones(10)])
        assert w.sql(q).rows() == [(100_010, 100_010.0)]

    with mvcc.pinned_scope(s.catalog, ["p"]):
        assert s.sql(q).rows() == [(100_000, 100_000.0)]
        ver = mvcc.current_pin().manifest_for(data).version
        plates = {k: v for k, v in data._device_cache.items()
                  if k[0] == ver}
        assert plates
        th = threading.Thread(target=other_session)
        th.start()
        th.join(timeout=120)
        assert any(k[0] > ver for k in data._device_cache)
        for k, entry in plates.items():
            assert data._device_cache.get(k) is entry
        assert s.sql(q).rows() == [(100_000, 100_000.0)]
        assert data._device_cache.get(next(iter(plates))) is \
            next(iter(plates.values()))
    assert s.sql(q).rows() == [(100_010, 100_010.0)]
    assert not any(k[0] == ver for k in data._device_cache)


def _close_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None or isinstance(b, (str, int)):
                assert a == b
            else:
                assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.cuda
def test_cuda_complex_plates_launch_both_kernels(cuda_device):
    """The nested-orders queries over ARRAY / MAP / STRUCT plates on the
    card: the plates live on the GPU, N1 launches the grouped kernel and
    N2 the Kahan kernel with no host fallback, and both answer as a CPU
    session under float32 plates."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.utils import tpch

    nested = tpch.gen_orders_nested(tpch.gen_orders(20_000, 2_000),
                                    tpch.gen_lineitem(80_000, 7))
    cols = ["o_orderkey", "o_orderdate", "info", "modes", "prices",
            "qty_by_mode"]
    props, saved = _f32_cpu_policy()
    knobs = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = props.pallas_group_reduce = True
    try:
        rows = {}
        for dev in ("cpu", cuda_device):
            s = SnappySession(catalog=Catalog(), device=dev)
            s.sql(tpch.ORDERS_NESTED_DDL)
            s.insert_arrays("orders_nested", [nested[c] for c in cols])
            fb = global_registry().counter("host_fallbacks")
            gr.grouped_reduce.launches = 0
            kr.masked_kahan_sum.launches = 0
            rows[str(dev)] = (s.sql(tpch.NESTED_N1).rows(),
                              s.sql(tpch.NESTED_N2).rows())
            assert global_registry().counter("host_fallbacks") == fb
            if dev != "cpu":
                assert gr.grouped_reduce.launches >= 1
                assert kr.masked_kahan_sum.launches >= 1
                data = s.catalog.describe("orders_nested").data
                tensors = [t for entry in data._device_cache.values()
                           for key, val in entry.items()
                           if isinstance(key, tuple)
                           and key[0].startswith("_build_")
                           for t in torch.utils._pytree.tree_leaves(val)
                           if isinstance(t, torch.Tensor)]
                assert tensors and all(t.is_cuda for t in tensors)
    finally:
        props.decimal_as_float64 = saved
        props.pallas_reduce, props.pallas_group_reduce = knobs
    for got, want in zip(rows[str(cuda_device)], rows["cpu"]):
        _close_rows(got, want)


@pytest.mark.cuda
def test_cuda_recovered_table_launches_both_kernels(cuda_device, tmp_path):
    """A durable lineitem (checkpoint, then an UPDATE and a DELETE in the
    WAL tail) recovered by a second session on the card: Q1 and Q6 launch
    both kernels on the recovered plates and answer as the same directory
    recovered on the CPU under float32 plates."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.utils import tpch

    d = str(tmp_path)
    props, saved = _f32_cpu_policy()
    knobs = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = props.pallas_group_reduce = True
    try:
        w = SnappySession(catalog=Catalog(), data_dir=d, recover=False,
                          device=cuda_device)
        w.sql(tpch.LINEITEM_DDL)
        li = tpch.gen_lineitem(200_000, 4)
        w.insert_arrays("lineitem", [li[f.name] for f in
                                     w.catalog.describe("lineitem")
                                     .schema.fields])
        w.checkpoint()
        w.sql("DELETE FROM lineitem WHERE l_quantity >= 49")
        w.sql("UPDATE lineitem SET l_discount = l_discount + 0.01 "
              "WHERE l_discount < 0.10")
        rows = {}
        for dev in ("cpu", cuda_device):
            s = SnappySession(data_dir=d, device=dev)
            gr.grouped_reduce.launches = 0
            kr.masked_kahan_sum.launches = 0
            rows[str(dev)] = (s.sql(tpch.Q1).rows(), s.sql(tpch.Q6).rows())
            if dev != "cpu":
                assert gr.grouped_reduce.launches >= 1
                assert kr.masked_kahan_sum.launches >= 1
            s.disk_store.close()
        w.disk_store.close()
    finally:
        props.decimal_as_float64 = saved
        props.pallas_reduce, props.pallas_group_reduce = knobs
    for got, want in zip(rows[str(cuda_device)], rows["cpu"]):
        _close_rows(got, want)


@pytest.mark.cuda
def test_cuda_ledger_device_bytes_equal_the_storage_bytes(cuda_device):
    """The broker's device ledger of a table is the bytes of the distinct
    storages of its cached plates: every tensor of every entry counted
    once per storage, whatever views and plate tuples share them."""
    from snappydata_tpu_torch.resource import global_broker
    from snappydata_tpu_torch.storage.device import _tensor_leaves

    s = _tiled_session(cuda_device, 1 << 20, 1 << 16)
    s.sql(TILED_Q)
    data = s.catalog.describe("tl").data
    storages = {}
    for t in _tensor_leaves(list(data._device_cache.values())):
        assert t.is_cuda
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    led = global_broker().ledger()
    assert led["device"]["tl"] == sum(storages.values()) > 0
    from snappydata_tpu_torch.storage.device import \
        device_cache_bytes_by_device

    by_dev = device_cache_bytes_by_device([("tl", data)])
    assert by_dev == {str(cuda_device) if cuda_device.index is not None
                      else "cuda:0": led["device"]["tl"]}


@pytest.mark.cuda
def test_cuda_demotion_lowers_memory_allocated(cuda_device):
    """HBM -> host demotion drops the table's plates: once the query's
    own references are gone, `memory_allocated` falls by at least the
    ledger's device bytes of the table, and the next query rebinds and
    answers the same."""
    import gc

    from snappydata_tpu_torch.resource import global_broker
    from snappydata_tpu_torch.storage import tier

    s = _tiled_session(cuda_device, 1 << 21, 1 << 16)
    want = s.sql(TILED_Q).rows()
    data = s.catalog.describe("tl").data
    s.executor.clear_cache()      # compiled plans hold no plates past here
    gc.collect()
    torch.cuda.synchronize()
    ledger = global_broker().ledger()["device"]["tl"]
    before = torch.cuda.memory_allocated()
    assert tier.demote_device([("tl", data)], 1 << 40) > 0
    gc.collect()
    torch.cuda.synchronize()
    probe = torch.empty(1, device=cuda_device)
    del probe
    after = torch.cuda.memory_allocated()
    assert global_broker().ledger()["device"].get("tl", 0) == 0
    assert before - after >= ledger, (before, after, ledger)
    got = s.sql(TILED_Q).rows()
    assert [r[:2] for r in got] == [r[:2] for r in want]


@pytest.mark.cuda
def test_cuda_cancelled_tiled_pass_leaves_no_bytes(cuda_device):
    """A tiled pass cancelled after its first tile raises XCL52 before
    its last tile, stops its prefetcher, releases its pin, deregisters
    the query, and leaves `memory_allocated` where it found it; the next
    query answers."""
    import contextlib
    import gc
    import threading

    import snappydata_tpu_torch.session as session_mod
    from snappydata_tpu_torch import config, resource
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage import mvcc, prefetch

    s = _tiled_session(cuda_device, 1 << 21, 1 << 16)
    data = s.catalog.describe("tl").data
    props = config.global_properties()
    saved = props.scan_tile_bytes
    reg = global_registry()
    first_tile = threading.Event()
    orig = session_mod.scan_window

    @contextlib.contextmanager
    def slow_window(d, lo, hi, manifest=None, **kw):
        with orig(d, lo, hi, manifest, **kw):
            yield
        first_tile.set()
        time.sleep(0.05)

    errs = []
    try:
        props.scan_tile_bytes = (1 << 21) * 25 // 16
        # the reference run on a thread of its own as well: a thread's
        # first cuBLAS call (the matmul lane) allocates a 32 MiB
        # workspace for its handle, which torch keeps pooled; that is the
        # thread's, not the pass's
        got = []
        warm = threading.Thread(target=lambda: got.append(
            s.sql(TILED_Q).rows()))
        warm.start()
        warm.join(60)
        want = got[0]
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        session_mod.scan_window = slow_window
        t0 = reg.counter("scan_tiles")

        def run():
            try:
                s.sql(TILED_Q)
                errs.append(None)
            except Exception as e:      # noqa: BLE001
                errs.append(e)

        th = threading.Thread(target=run)
        th.start()
        assert first_tile.wait(30)
        qid = [q["id"] for q in resource.global_broker().queries()
               if "FROM tl" in q["sql"]][0]
        assert resource.global_broker().cancel(qid)
        th.join(60)
    finally:
        session_mod.scan_window = orig
        props.scan_tile_bytes = saved
    assert isinstance(errs[0], resource.CancelException)
    assert "XCL52" in str(errs[0])
    assert reg.counter("scan_tiles") - t0 < 16
    assert not s._in_tile and not mvcc.has_pins(data)
    assert not prefetch.keep_windows(data)
    assert all(q["id"] != qid for q in resource.global_broker().queries())
    gc.collect()
    torch.cuda.synchronize()
    # one allocation lets the caching allocator retire blocks whose
    # record_stream events have completed
    probe = torch.empty(1, device=cuda_device)
    del probe
    after = torch.cuda.memory_allocated()
    live = sorted((o.untyped_storage().nbytes(), tuple(o.shape), str(o.dtype))
                  for o in gc.get_objects()
                  if torch.is_tensor(o) and o.is_cuda) \
        if after > before else []
    assert after <= before, (before, after, live[-8:])
    # float64 sums merge in no fixed order on the card: equal to rounding
    got = s.sql(TILED_Q).rows()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a[0], a[1], a[3], a[4]) == (b[0], b[1], b[3], b[4])
        assert a[2] == pytest.approx(b[2], rel=1e-12)


# --- views, materialized views and SQL functions on the card ----------------

@pytest.mark.cuda
def test_cuda_modulo_by_zero_gives_zero(cuda_device):
    """Fault C3 on CUDA: an integer zero divisor gives 0 (the reference's
    jnp `%`), never the undefined value of an unguarded division; NULL
    stays NULL, and nothing leaves the device."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry

    s = SnappySession(catalog=Catalog())
    s.sql("CREATE TABLE z (b BIGINT, g INT, m DECIMAL(10,2)) USING column")
    s.sql("INSERT INTO z VALUES (7, 0, 2.50), (-7, 2, 0.00), "
          "(NULL, 3, NULL)")
    reg = global_registry()
    h0 = reg.counter("host_fallbacks")
    assert s.sql("SELECT b % g FROM z ORDER BY g").rows() == \
        [(0,), (1,), (None,)]
    assert s.sql("SELECT b % 0 FROM z ORDER BY g").rows() == \
        [(0,), (0,), (None,)]
    assert [r[0] for r in s.sql("SELECT m % m FROM z ORDER BY g").rows()] \
        == [0, 0, None]
    assert s.sql("SELECT sum(b % g) FROM z").rows() == [(1,)]
    assert s.sql("SELECT b FROM z WHERE b % g = 1").rows() == [(-7,)]
    assert reg.counter("host_fallbacks") == h0


@pytest.mark.cuda
def test_cuda_round_rounds_in_float64(cuda_device):
    """Fault C7 on CUDA, whose default plates are float32: round(x, d)
    promotes the plate against its float64 scale and rounds in float64,
    as the reference does, so 3.35 (3.3499999 as float32) gives 3.3; an
    integer column rounds in float64 with or without digits."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry

    s = SnappySession(catalog=Catalog())
    s.sql("CREATE TABLE rt (id BIGINT, x DOUBLE, k BIGINT) USING column")
    s.sql("INSERT INTO rt VALUES (0, 3.35, 123456789), "
          "(4, -2.35, 987654321)")
    reg = global_registry()
    h0 = reg.counter("host_fallbacks")
    assert s.sql("SELECT id, round(x, 1) FROM rt ORDER BY id").rows() == \
        [(0, 3.3), (4, -2.3)]
    assert s.sql("SELECT count(*) FROM rt WHERE round(x, 1) = 3.4"
                 ).rows() == [(0,)]
    assert s.sql("SELECT round(x, 1) AS r, count(*) FROM rt "
                 "GROUP BY round(x, 1) ORDER BY r").rows() == \
        [(-2.3, 1), (3.3, 1)]
    assert s.sql("SELECT round(k), round(k, 1) FROM rt ORDER BY id"
                 ).rows() == [(123456789.0, 123456789.0),
                              (987654321.0, 987654321.0)]
    assert reg.counter("host_fallbacks") == h0


@pytest.mark.cuda
def test_cuda_udf_runs_on_card_tensors(cuda_device):
    """A SQL function's body runs on the plates' CUDA tensors inside the
    device program (no host fallback), its result cast to the float32
    plate of RETURNS DOUBLE; the global sum launches the Kahan kernel."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.sql import udf

    s = SnappySession(catalog=Catalog())
    s.sql("CREATE TABLE u (p DOUBLE, d DOUBLE) USING column")
    rng = np.random.default_rng(3)
    p = np.round(rng.random(100_000) * 1000, 2)
    d = np.round(rng.random(100_000) * 0.1, 2)
    s.insert_arrays("u", [p, d])
    s.sql("CREATE FUNCTION rev AS 'lambda p, d: p * d' RETURNS DOUBLE")
    s.sql("CREATE FUNCTION capped AS 'lambda x: jnp.clip(x, 10, 40)'")
    seen = []
    real = udf.device_lane

    def spy(device):
        seen.append(device)
        return real(device)

    udf.device_lane = spy
    props = __import__("snappydata_tpu_torch.config",
                       fromlist=["x"]).global_properties()
    old = props.pallas_reduce
    props.pallas_reduce = True
    try:
        reg = global_registry()
        h0 = reg.counter("host_fallbacks")
        k0 = masked_kahan_sum.launches
        got = s.sql("SELECT sum(rev(p, d)), sum(capped(p)) FROM u").rows()[0]
        assert reg.counter("host_fallbacks") == h0
        assert masked_kahan_sum.launches > k0
    finally:
        udf.device_lane = real
        props.pallas_reduce = old
    assert seen and all(dv.type == "cuda" for dv in seen)
    pf, df = p.astype(np.float32), d.astype(np.float32)
    assert got[0] == pytest.approx(float((pf * df).astype(np.float64).sum()),
                                   rel=1e-6)
    assert got[1] == pytest.approx(float(np.clip(pf, 10, 40).sum()),
                                   rel=1e-6)


@pytest.mark.cuda
def test_cuda_matview_state_on_the_card(cuda_device):
    """A materialized view's [G] state lives on the card in float64 /
    int64, a fold merges there (index_add_ and scatter_reduce_), the
    broker ledgers exactly `state_nbytes()`, and DROP frees it."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.resource import global_broker
    from snappydata_tpu_torch.views import matview

    s = SnappySession(catalog=Catalog())
    s.sql("CREATE TABLE b (k INT, v DOUBLE, n BIGINT) USING column")
    rng = np.random.default_rng(5)
    k = rng.integers(0, 300, 50_000).astype(np.int32)
    v = np.round(rng.random(50_000) * 100, 2)
    n = rng.integers(0, 1000, 50_000)
    s.insert_arrays("b", [k, v, n])
    led0 = global_broker().ledger()["matview_state_bytes"]
    s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv, "
          "sum(n) AS sn, max(v) AS mx, count(*) AS c FROM b GROUP BY k")
    mv = matview.matviews(s.catalog)["mv"]
    assert [t.dtype for t in mv._vals] == [torch.float64, torch.int64,
                                           torch.float64, torch.int64]
    assert all(t.is_cuda for t in mv._vals) and mv._rowcount.is_cuda
    assert global_broker().ledger()["matview_state_bytes"] - led0 == \
        mv.state_nbytes() > 0
    k2 = np.array([1, 1, 299, 400], dtype=np.int32)
    v2 = np.array([500.0, 1.0, 2.0, 3.0])
    n2 = np.array([1, 2, 3, 4])
    s.insert_arrays("b", [k2, v2, n2])
    assert mv.folds >= 1
    kk, vv, nn = np.concatenate([k, k2]), np.concatenate([v, v2]), \
        np.concatenate([n, n2])
    rows = s.sql("SELECT * FROM mv ORDER BY k").rows()
    assert len(rows) == len(np.unique(kk))
    for key, sv, sn, mx, c in rows:
        g = kk == key
        assert c == int(g.sum()) and sn == int(nn[g].sum())
        assert sv == pytest.approx(float(vv[g].astype(np.float32)
                                         .astype(np.float64).sum()),
                                   rel=1e-6)
        assert mx == pytest.approx(float(vv[g].max()), rel=1e-6)
    s.sql("DROP MATERIALIZED VIEW mv")
    assert global_broker().ledger()["matview_state_bytes"] <= led0


@pytest.mark.cuda
def test_cuda_fold_under_one_query_limit(cuda_device, monkeypatch):
    """Folds inside INSERT ... SELECT and a stale view's refresh inside a
    query run under the statement's own query context: under a memory
    limit that admits one query at a time they must not queue behind
    their own statement."""
    import threading

    from snappydata_tpu_torch import SnappySession, config, resource
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.views import matview

    props = config.global_properties()
    old = (props.memory_limit_bytes, props.query_timeout_s)
    props.memory_limit_bytes = 1 << 20
    props.query_timeout_s = 20.0
    monkeypatch.setattr(resource, "estimate_statement_bytes",
                        lambda catalog, stmt: 1 << 20)
    out = []
    try:
        s = SnappySession(catalog=Catalog())
        s.sql("CREATE TABLE b (k INT, v DOUBLE) USING column")
        s.sql("CREATE TABLE src (k INT, v DOUBLE) USING column")
        s.sql("INSERT INTO b VALUES (1, 1.0), (2, 2.0)")
        s.sql("INSERT INTO src VALUES (1, 10.0), (3, 30.0)")
        s.sql("CREATE MATERIALIZED VIEW mv AS SELECT k, sum(v) AS sv "
              "FROM b GROUP BY k")

        def work():
            try:
                s.sql("INSERT INTO b SELECT * FROM src")
                matview.matviews(s.catalog)["mv"].mark_stale("test")
                out.append(s.sql("SELECT * FROM mv ORDER BY k").rows())
            except Exception as e:  # pragma: no cover - reported below
                out.append(e)

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(60)
        assert not th.is_alive(), "a fold or refresh queued behind itself"
    finally:
        props.memory_limit_bytes, props.query_timeout_s = old
    assert out == [[(1, 11.0), (2, 2.0), (3, 30.0)]], out


def _serving_lineitem(n_rows=2_000_000):
    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.utils import tpch

    props = config.global_properties()
    saved = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    s = SnappySession(catalog=Catalog())
    s.sql(tpch.LINEITEM_DDL)
    s.insert_arrays("lineitem", list(tpch.gen_lineitem(n_rows, 7).values()))
    return s, tpch, props, saved


SERVING_Q6 = ("SELECT sum(l_extendedprice * l_discount) AS revenue "
              "FROM lineitem WHERE l_shipdate >= ? AND l_shipdate < ? "
              "AND l_discount BETWEEN ? AND ? AND l_quantity < ?")
SERVING_Q1 = ("SELECT l_returnflag, l_linestatus, sum(l_quantity), "
              "sum(l_extendedprice), "
              "sum(l_extendedprice * (1 - l_discount)), count(*) "
              "FROM lineitem WHERE l_shipdate <= ? "
              "GROUP BY l_returnflag, l_linestatus "
              "ORDER BY l_returnflag, l_linestatus")


@pytest.mark.cuda
def test_cuda_fused_q6_batch_equals_solo_bit_for_bit(cuda_device):
    """A fused batch of 16 Q6 binds runs the Kahan kernel once per
    request on one bind and brings the batch home in one copy; each
    answer equals its solo execute bit for bit (the kernel's cross-block
    combine runs in a fixed order)."""
    from snappydata_tpu_torch.observability.metrics import global_registry

    s, tpch, props, saved = _serving_lineitem()
    try:
        entry = s.prepare(SERVING_Q6)._entry
        compiled = entry.compiled_for(s)
        binds = []
        for year in range(1993, 1997):
            for lo in (0.02, 0.04, 0.05, 0.07):
                binds.append(entry.lit_params + (
                    tpch._days(f"{year}-01-01"),
                    tpch._days(f"{year + 1}-01-01"), lo, lo + 0.02, 24))
        reg = global_registry()
        t0 = reg.counter("serving_bulk_transfers")
        k0 = masked_kahan_sum.launches
        tables, outs = compiled.execute_batched(binds, s.device)
        launched = masked_kahan_sum.launches - k0
        assert launched == 16, launched
        assert reg.counter("serving_bulk_transfers") - t0 == 1
        fused = [entry.assemble_batched(s, outs, tables, i, p).rows()
                 for i, p in enumerate(binds)]
        with config.device_scope(s.device):
            solo = [s.executor.execute(entry.tokenized, p).rows()
                    for p in binds]
        assert fused == solo, (fused, solo)
        assert any(r[0][0] for r in fused)
    finally:
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_batched_q1_equals_solo(cuda_device):
    """A fused batch of Q1 with a bound ship date launches the grouped
    kernel once per request and equals the solo executes."""
    s, tpch, props, saved = _serving_lineitem()
    try:
        entry = s.prepare(SERVING_Q1)._entry
        compiled = entry.compiled_for(s)
        binds = [entry.lit_params + (tpch._days(d),) for d in
                 ("1993-06-30", "1995-06-17", "1998-09-02", "1992-01-01")]
        g0 = gr.grouped_reduce.launches
        tables, outs = compiled.execute_batched(binds, s.device)
        assert gr.grouped_reduce.launches - g0 == len(binds)
        for i, p in enumerate(binds):
            got = entry.assemble_batched(s, outs, tables, i, p).rows()
            with config.device_scope(s.device):
                solo = s.executor.execute(entry.tokenized, p).rows()
            assert got == solo, i
    finally:
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_gidx_hit_launches_the_grouped_kernel_once(cuda_device):
    """A group-index cache hit gives the miss's rows, launches only phase
    B (the grouped kernel once), and its entry holds the card's int32
    index and bool validity: 5 bytes a bound row."""
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.resource import global_broker

    s, tpch, props, saved = _serving_lineitem()
    executor.clear_gidx_cache()
    try:
        h = s.prepare(SERVING_Q1)
        bind = (tpch._days("1998-09-02"),)
        reg = global_registry()
        m0, h0 = reg.counter("gidx_cache_misses"), \
            reg.counter("gidx_cache_hits")
        miss = h.execute(bind).rows()
        g0 = gr.grouped_reduce.launches
        hit = h.execute(bind).rows()
        assert gr.grouped_reduce.launches - g0 == 1
        assert hit == miss
        assert reg.counter("gidx_cache_misses") - m0 == 1
        assert reg.counter("gidx_cache_hits") - h0 == 1
        data = s.catalog.describe("lineitem").data
        rows = sum(t.valid.numel() for t in [
            executor.build_device_table(data, [0], s.device)])
        assert executor.gidx_cache_nbytes() == 5 * rows
        assert global_broker().ledger()["gidx_cache_bytes"] == \
            executor.gidx_cache_nbytes()
    finally:
        executor.clear_gidx_cache()
        props.pallas_reduce, props.pallas_group_reduce = saved


def _analyze_field(rows, needle, key):
    line = next(r[0] for r in rows if needle in r[0])
    for tok in line.replace("]", " ").replace("[", " ").split():
        if tok.startswith(key + "="):
            return tok.split("=", 1)[1]
    raise AssertionError(f"{key}= not in {line!r}")


@pytest.mark.cuda
def test_cuda_explain_analyze_names_and_launches_the_kernels(cuda_device):
    """EXPLAIN ANALYZE of Q1 and Q6 on the card: the footer's strategies
    name "grouped" / "kahan", the ANALYZE run launches that kernel once,
    the rows out equal the plain query's, and plain EXPLAIN launches
    nothing."""
    from snappydata_tpu_torch.observability import tracing

    s, tpch, props, saved = _serving_lineitem()
    try:
        for q, kernel, lane in ((tpch.Q1, gr.grouped_reduce, "grouped"),
                                (tpch.Q6, kr.masked_kahan_sum, "kahan")):
            rows = s.sql(q).rows()
            n0 = kernel.launches
            s.sql("EXPLAIN " + q)
            assert kernel.launches == n0
            out = s.sql("EXPLAIN ANALYZE " + q).rows()
            assert kernel.launches == n0 + 1
            assert lane in _analyze_field(out, "HashAggregate",
                                          "strategy").split(",")
            assert int(_analyze_field(out, "trace_id=", "rows_out")) \
                == len(rows)
            tid = _analyze_field(out, "trace_id=", "trace_id")
            assert tracing.ring().get(tid)
    finally:
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_traced_query_synchronizes_no_more_than_untraced(
        cuda_device, monkeypatch):
    """No span waits on the card: a traced Q6 calls
    torch.cuda.synchronize no more often than an untraced one."""
    s, tpch, props, saved = _serving_lineitem()
    traced = props.tracing_enabled
    calls = []
    real = torch.cuda.synchronize

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    try:
        s.sql(tpch.Q6).rows()              # warm: plates bound
        counts = {}
        monkeypatch.setattr(torch.cuda, "synchronize", counting)
        for on in (True, False):
            props.tracing_enabled = on
            calls.clear()
            s.sql(tpch.Q6).rows()
            counts[on] = len(calls)
        assert counts[True] <= counts[False], counts
    finally:
        props.tracing_enabled = traced
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_for_user_keeps_the_parent_device(cuda_device):
    """A session derived for a principal runs on its parent's card, and
    its granted Q6 equals the admin's bit for bit with one Kahan
    launch; without the grant it launches nothing."""
    s, tpch, props, saved = _serving_lineitem()
    try:
        u = s.for_user("analyst")
        assert u.device == s.device == torch.device("cuda")
        n0 = kr.masked_kahan_sum.launches
        with pytest.raises(PermissionError):
            u.sql(tpch.Q6)
        assert kr.masked_kahan_sum.launches == n0
        admin = s.sql(tpch.Q6).rows()
        s.sql("GRANT SELECT ON lineitem TO analyst")
        n0 = kr.masked_kahan_sum.launches
        assert u.sql(tpch.Q6).rows() == admin
        assert kr.masked_kahan_sum.launches == n0 + 1
    finally:
        props.pallas_reduce, props.pallas_group_reduce = saved


def _serve_flight(s):
    import threading

    from snappydata_tpu_torch.cluster.flight_server import SnappyFlightServer

    srv = SnappyFlightServer(s)
    threading.Thread(target=srv.serve, daemon=True).start()
    srv.wait_ready()
    return srv


@pytest.mark.cuda
def test_cuda_flight_and_rest_q6_launch_kahan_on_the_session_card(
        cuda_device):
    """Q6 served through Flight (a gRPC thread pyarrow started) and
    through REST `POST /sql` (a ThreadingHTTPServer thread) runs on the
    server session's card: one Kahan launch each, the answer equal to
    the session's own; a served Q1 makes one grouped launch."""
    import json
    import urllib.request

    from snappydata_tpu_torch.cluster.client import SnappyClient
    from snappydata_tpu_torch.cluster.rest import RestService
    from snappydata_tpu_torch.observability import TableStatsService

    s, tpch, props, saved = _serving_lineitem()
    srv = _serve_flight(s)
    svc = RestService(s, TableStatsService(s.catalog)).start()
    c = SnappyClient(address=f"127.0.0.1:{srv.port}")
    try:
        local6 = s.sql(tpch.Q6).rows()
        local1 = s.sql(tpch.Q1).rows()
        n0 = kr.masked_kahan_sum.launches
        t = c.sql(tpch.Q6)
        assert kr.masked_kahan_sum.launches == n0 + 1
        assert t.column(0)[0].as_py() == local6[0][0]
        g0 = gr.grouped_reduce.launches
        t1 = c.sql(tpch.Q1)
        assert gr.grouped_reduce.launches == g0 + 1
        assert [tuple(r.values()) for r in t1.to_pylist()] == [
            tuple(r) for r in local1]
        n0 = kr.masked_kahan_sum.launches
        req = urllib.request.Request(
            f"http://{svc.host}:{svc.port}/sql",
            data=json.dumps({"sql": tpch.Q6}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req).read())
        assert kr.masked_kahan_sum.launches == n0 + 1
        assert body["rows"][0][0] == local6[0][0]
    finally:
        c.close()
        svc.stop()
        srv.shutdown()
        s.stop()
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_handler_without_its_card_raises(cuda_device, monkeypatch):
    """A server whose session names a card the machine lacks: the served
    query raises through Flight, and neither the kernel nor its plain
    CPU version runs."""
    import pyarrow.flight as flight

    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.cluster.client import SnappyClient
    from snappydata_tpu_torch.utils import tpch

    plain_calls = []
    real_plain = kr.masked_kahan_sum_plain
    monkeypatch.setattr(kr, "masked_kahan_sum_plain",
                        lambda *a, **kw: plain_calls.append(1)
                        or real_plain(*a, **kw))
    missing = torch.device("cuda", torch.cuda.device_count())
    s = SnappySession(catalog=Catalog(), device=missing)
    s.sql(tpch.LINEITEM_DDL)
    s.insert_arrays("lineitem", list(tpch.gen_lineitem(10_000, 7).values()))
    srv = _serve_flight(s)
    c = SnappyClient(address=f"127.0.0.1:{srv.port}")
    try:
        n0 = kr.masked_kahan_sum.launches
        with pytest.raises(flight.FlightError):
            c.sql(tpch.Q6)
        assert kr.masked_kahan_sum.launches == n0
        assert not plain_calls
    finally:
        c.close()
        srv.shutdown()
        s.stop()


@pytest.mark.cuda
def test_cuda_stream_micro_batches_reach_both_kernels(cuda_device):
    """A memory stream on the card: its micro-batch thread appends on the
    session's device, and Q6 / Q1 over the stream table launch the Kahan
    and the grouped kernels once each."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.utils import tpch

    props = config.global_properties()
    saved = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = props.pallas_group_reduce = True
    s = SnappySession(catalog=Catalog())
    try:
        cols = tpch.gen_lineitem(200_000, 7)
        columns = tpch.LINEITEM_DDL.split("(", 1)[1].split(") USING")[0]
        s.sql(f"CREATE STREAM TABLE ls ({columns}) USING memory_stream "
              "OPTIONS (interval '0.01')")
        src = s.stream_source("ls")
        for lo in range(0, 200_000, 50_000):
            src.add_batch({k: v[lo:lo + 50_000] for k, v in cols.items()})
        deadline = time.time() + 60
        while time.time() < deadline and \
                s.sql("SELECT count(*) FROM ls").rows()[0][0] < 200_000:
            time.sleep(0.05)
        n0, g0 = kr.masked_kahan_sum.launches, gr.grouped_reduce.launches
        s.sql(tpch.Q6.replace("lineitem", "ls")).rows()
        s.sql(tpch.Q1.replace("lineitem", "ls")).rows()
        assert kr.masked_kahan_sum.launches == n0 + 1
        assert gr.grouped_reduce.launches == g0 + 1
    finally:
        for q in s.catalog._streams.values():
            q.stop()
        s.stop()
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_explain_analyze_counts_kernel_launches(cuda_device):
    """EXPLAIN ANALYZE on the card: the `kernels` line names the card,
    the lineitem plates resident on it and the launches of this pass,
    equal to the wrappers' own counts around it."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.utils import tpch

    props = config.global_properties()
    saved = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = props.pallas_group_reduce = True
    s = SnappySession(catalog=Catalog())
    try:
        s.sql(tpch.LINEITEM_DDL)
        s.insert_arrays("lineitem", list(tpch.gen_lineitem(200_000,
                                                           7).values()))
        for q, lc in ((tpch.Q1, gr.grouped_reduce),
                      (tpch.Q6, kr.masked_kahan_sum)):
            n0 = lc.launches
            rows = s.sql("EXPLAIN ANALYZE " + q).rows()
            line = next(r[0] for r in rows if r[0].startswith("kernels "))
            fields = dict(t.split("=", 1) for t in line.split()[1:])
            assert fields["device"].startswith("cuda")
            assert int(fields["resident_bytes"]) > 0
            assert fields[lc.__name__] == f"{lc.launches - n0}/{lc.launches}"
            assert lc.launches - n0 >= 1
    finally:
        s.stop()
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_distributed_q1_q6_over_two_servers(cuda_device):
    """A DistributedSession on the card (no device=) over two in-process
    ServerNodes on the card, under the float32 plate policy: the
    scattered Q1 / Q6 equal one session's rows within the compensated
    kernels' bar, each server launching the grouped kernel for Q1's
    partial and the Kahan kernel for Q6's, and the lead's merge runs on
    its own card."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.cluster import LocatorNode, ServerNode
    from snappydata_tpu_torch.cluster.distributed import DistributedSession
    from snappydata_tpu_torch.utils import tpch

    props = config.global_properties()
    saved = (props.pallas_reduce, props.pallas_group_reduce)
    props.pallas_reduce = props.pallas_group_reduce = True
    cols = tpch.gen_lineitem(400_000, 7)
    one = SnappySession(catalog=Catalog())
    loc = LocatorNode().start()
    servers = [ServerNode(loc.address, SnappySession(catalog=Catalog()))
               .start() for _ in range(2)]
    ds = DistributedSession(locator=loc.address)
    try:
        assert ds.device.type == "cuda"
        one.sql(tpch.LINEITEM_DDL)
        one.insert_arrays("lineitem", [np.array(a, copy=True)
                                       for a in cols.values()])
        ds.sql(tpch.LINEITEM_DDL)
        ds.insert_arrays("lineitem", list(cols.values()))
        counts = [s.session.sql("SELECT count(*) FROM lineitem").rows()[0][0]
                  for s in servers]
        assert sum(counts) == 400_000 and min(counts) > 0
        for q, lc in ((tpch.Q1, gr.grouped_reduce),
                      (tpch.Q6, kr.masked_kahan_sum)):
            want = one.sql(q).rows()
            n0 = lc.launches
            got = ds.sql(q).rows()
            assert lc.launches >= n0 + 2, (q, lc.launches - n0)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(b, float):
                        assert a == pytest.approx(b, rel=1e-6)
                    else:
                        assert a == b
        assert ds.last_downgrades == []
    finally:
        ds.close()
        for s in servers:
            s.stop()
        loc.stop()
        one.stop()
        props.pallas_reduce, props.pallas_group_reduce = saved


@pytest.mark.cuda
def test_cuda_four_slot_mesh_launches_per_slot(cuda_device):
    """A 4-slot mesh on cuda:0 (`mesh_slots` 4): Q1 and Q6 take
    the per-slot partial lane, launch the grouped and the Kahan kernel
    once per slot, and answer the single-device rows of the same session
    under the float32 policy (counts and keys exact, same-sign sums rel
    1e-7: the compensated kernels' bar)."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.parallel.mesh import Mesh, Slot
    from snappydata_tpu_torch.utils import tpch

    props = config.global_properties()
    saved = (props.pallas_reduce, props.pallas_group_reduce,
             props.mesh_slots)
    props.pallas_reduce = props.pallas_group_reduce = True
    props.mesh_slots = 4
    try:
        s = SnappySession(catalog=Catalog(), device=cuda_device)
        tpch.load_tpch(s, sf=0.05, seed=4)
        single = {q: s.sql(q).rows() for q in (tpch.Q1, tpch.Q6)}
        # four slots on cuda:0 whatever the machine's cards: data_mesh
        # would put slot i on card i % k
        s.default_mesh = Mesh([Slot(i, torch.device("cuda", 0))
                               for i in range(4)])
        assert [sl.device for sl in s.default_mesh.slots] == \
            [torch.device("cuda", 0)] * 4
        for q, lc in ((tpch.Q1, gr.grouped_reduce),
                      (tpch.Q6, kr.masked_kahan_sum)):
            n0 = lc.launches
            e0 = global_registry().counter("mesh_shard_execs")
            got = s.sql(q).rows()
            assert lc.launches - n0 == 4, (q, lc.launches - n0)
            assert global_registry().counter("mesh_shard_execs") == e0 + 1
            want = single[q]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(b, float):
                        assert a == pytest.approx(b, rel=1e-7)
                    else:
                        assert a == b
        s.stop()
    finally:
        (props.pallas_reduce, props.pallas_group_reduce,
         props.mesh_slots) = saved


def test_cuda_cross_card_mesh_reads_bind_time_blocks(cuda_device):
    """A mesh of one slot a card over every card (two or more): each slot
    on another card than cuda:0 reads its blocks from the copies the bind
    made there, so a warm Q1, Q6 and Q3C (broadcast, then shuffle) copy no
    block between cards (`mesh_block_copies`); each launches its kernel
    once a slot and answers the single-device rows (counts and keys
    exact, same-sign sums rel 1e-7), and the per-slot ledger counts every
    slot's block on its own card."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.parallel import data_mesh
    from snappydata_tpu_torch.storage.device import \
        device_cache_bytes_by_device
    from snappydata_tpu_torch.utils import tpch

    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs two or more cards")
    props = config.global_properties()
    saved = (props.pallas_reduce, props.pallas_group_reduce,
             props.mesh_slots, props.mesh_join_strategy)
    props.pallas_reduce = props.pallas_group_reduce = True
    props.mesh_slots = 0
    reg = global_registry()
    try:
        s = SnappySession(catalog=Catalog(), device=cuda_device)
        tpch.load_tpch(s, sf=0.05, seed=4)
        runs = [(tpch.Q1, gr.grouped_reduce, None),
                (tpch.Q6, kr.masked_kahan_sum, None),
                (tpch.Q3C, gr.grouped_reduce, "broadcast"),
                (tpch.Q3C, gr.grouped_reduce, "shuffle")]
        single = {q: s.sql(q).rows() for q, _, _ in runs}
        s.default_mesh = data_mesh()
        assert [str(sl.device) for sl in s.default_mesh.slots] == \
            [f"cuda:{i}" for i in range(k)]
        for q, lc, strategy in runs:
            if strategy is not None:
                props.mesh_join_strategy = strategy
            s.sql(q).rows()
            n0, c0 = lc.launches, reg.counter("mesh_block_copies")
            e0 = reg.counter("mesh_shard_execs")
            got = s.sql(q).rows()
            assert lc.launches - n0 == k, (q, strategy, lc.launches - n0)
            assert reg.counter("mesh_shard_execs") == e0 + 1
            assert reg.counter("mesh_block_copies") == c0, (q, strategy)
            want = single[q]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(b, float):
                        assert a == pytest.approx(b, rel=1e-7)
                    else:
                        assert a == b
        li = s.catalog.describe("lineitem").data
        per = device_cache_bytes_by_device([("lineitem", li)])
        for i in range(1, k):
            assert per.get(f"slot{i}:cuda:{i}", 0) > 0, per
        s.stop()
    finally:
        (props.pallas_reduce, props.pallas_group_reduce,
         props.mesh_slots, props.mesh_join_strategy) = saved


@pytest.mark.cuda
def test_cuda_value_dict_skipper_sees_update_deltas(cuda_device):
    """Fault C8 on CUDA: after an UPDATE of a VALUE_DICT column, the
    batch skipper keeps the batches whose deltas touch the column, so the
    25 updated rows are found; a value of untouched batches keeps its
    count, and nothing leaves the device."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry

    s = SnappySession(catalog=Catalog())
    s.sql("CREATE TABLE vd_t (k BIGINT, qty DOUBLE, price DOUBLE) "
          "USING column")
    rng = np.random.default_rng(7)
    n = 60_000
    qty = rng.integers(1, 51, n).astype(np.float64)
    s.insert_arrays("vd_t", [np.arange(n, dtype=np.int64), qty,
                             np.round(rng.uniform(900.0, 105_000.0, n), 2)])
    s.catalog.describe("vd_t").data.force_rollover()
    reg = global_registry()
    h0 = reg.counter("host_fallbacks")
    assert s.sql("SELECT count(*) FROM vd_t WHERE qty = 17.0").rows() == \
        [(int((qty == 17.0).sum()),)]
    s.sql("UPDATE vd_t SET qty = 999.0 WHERE k < 25")
    assert s.sql("SELECT count(*) FROM vd_t WHERE qty = 999.0").rows() == \
        [(25,)]
    assert s.sql("SELECT count(*) FROM vd_t WHERE qty = 17.0").rows() == \
        [(int((qty[25:] == 17.0).sum()),)]
    assert reg.counter("host_fallbacks") == h0


@pytest.mark.cuda
def test_cuda_unknown_provider_makes_a_column_table(cuda_device):
    """Fault C9 on CUDA: `USING parquet` and a CTAS `USING jdbc` make
    column tables under those provider names, bound on the card."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    s = SnappySession(catalog=Catalog())
    s.sql("CREATE TABLE a (x INT) USING parquet")
    s.sql("INSERT INTO a VALUES (1), (2), (3)")
    assert s.sql("SELECT sum(x) FROM a").rows() == [(6,)]
    assert s.catalog.describe("a").provider == "parquet"
    s.sql("CREATE TABLE b USING jdbc AS SELECT 1 AS x")
    assert s.sql("SELECT * FROM b").rows() == [(1,)]
    assert s.catalog.describe("b").provider == "jdbc"
    assert s.device.type == "cuda"
