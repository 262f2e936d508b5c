"""The PyTorch port's kernels against the JAX package's Pallas kernels.

Each test feeds the same numpy inputs, made from a seed, to the JAX
kernel (interpret mode on the CPU, as the JAX package's own tests run it)
and to the port's wrapper on CPU tensors — which runs the kernel's plain
PyTorch version — and holds both to an exact float64 oracle with the
reference's tolerances: rel 1e-7 on same-sign data, 1e-6 * sum(|v|) where
signs mix, exact counts and min/max.

The CUDA kernels themselves are held against their plain versions in
tests/test_torch_cuda.py, on the card.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappydata_tpu.ops.pallas_group import grouped_reduce as jax_grouped
from snappydata_tpu.ops.pallas_reduce import masked_kahan_sum as jax_kahan
from snappydata_tpu_torch.ops import group_reduce as gr
from snappydata_tpu_torch.ops import kahan_reduce as kr
from snappydata_tpu_torch.ops.kahan_reduce import masked_kahan_sum


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- masked_kahan_sum ------------------------------------------------------

def test_kahan_same_sign_large():
    # plain f32 accumulation keeps ~3 digits at this magnitude; the
    # compensated sum keeps ~eps, and the s - c combine sign is pinned
    rng = np.random.default_rng(1)
    v = (rng.random(131_072) * 2e4).astype(np.float32)
    m = np.ones(v.shape, dtype=bool)
    exact = float(v.astype(np.float64).sum())
    got = float(masked_kahan_sum(_t(v), _t(m)))
    ref = float(jax_kahan(jnp.asarray(v), jnp.asarray(m)))
    assert abs(got - exact) / exact <= 1e-7
    assert abs(ref - exact) / exact <= 1e-7
    plain = float(v.sum(dtype=np.float32))
    assert abs(got - exact) <= abs(plain - exact) / 10


@pytest.mark.parametrize("n", [1, 7, 1024, 1025, 131072, 131073])
def test_kahan_mask_and_padding(n):
    rng = np.random.default_rng(2 + n)
    v = (rng.random(n) * 100 - 50).astype(np.float32)
    m = rng.random(n) < 0.5
    exact = float(v.astype(np.float64)[m].sum())
    bound = 1e-6 * float(np.abs(v.astype(np.float64)[m]).sum()) + 1e-6
    got = float(masked_kahan_sum(_t(v), _t(m)))
    ref = float(jax_kahan(jnp.asarray(v), jnp.asarray(m)))
    assert abs(got - exact) <= bound
    assert abs(got - ref) <= 2 * bound


def test_kahan_cancellation_bound():
    """The compensated f32 sum bounds its error by sum(|v|), not by
    |sum(v)| — the reason the lane stays opt-in."""
    v = np.array([1.6e7] * 1000 + [-1.6e7] * 1000 + [1.0],
                 dtype=np.float32)
    m = np.ones(v.shape, dtype=bool)
    abs_scale = float(np.abs(v.astype(np.float64)).sum())
    got = float(masked_kahan_sum(_t(v), _t(m)))
    ref = float(jax_kahan(jnp.asarray(v), jnp.asarray(m)))
    assert abs(got - 1.0) <= 1e-7 * abs_scale
    assert abs(ref - 1.0) <= 1e-7 * abs_scale


def test_kahan_result_is_float64_scalar():
    out = masked_kahan_sum(torch.ones(5), torch.ones(5, dtype=torch.bool))
    assert out.dtype == torch.float64 and out.dim() == 0
    assert float(out) == 5.0


@pytest.mark.parametrize("n,offset", [(4099, 1), (4099, 2), (4099, 3),
                                      (131_071, 1), (131_075, 3)])
def test_kahan_ragged_offset_views(n, offset):
    """Views that start 1 - 3 rows into their buffers, over ragged
    lengths, against the reference on the same rows: mixed signs, so
    1e-6 * sum(|v|) of the exact sum (+1e-6 absolute)."""
    rng = np.random.default_rng(20 + n + offset)
    v = (rng.random(n + offset) * 200 - 100).astype(np.float32)
    m = rng.random(n + offset) < 0.7
    got = float(masked_kahan_sum(_t(v)[offset:], _t(m)[offset:]))
    v, m = v[offset:], m[offset:]
    exact = float(v.astype(np.float64)[m].sum())
    bound = 1e-6 * float(np.abs(v.astype(np.float64)[m]).sum()) + 1e-6
    ref = float(jax_kahan(jnp.asarray(v), jnp.asarray(m)))
    assert abs(got - exact) <= bound
    assert abs(got - ref) <= 2 * bound


def test_kahan_empty_and_all_false_are_exact_zero():
    for v, m in ((torch.ones(0), torch.ones(0, dtype=torch.bool)),
                 (torch.full((1000,), 3.5), torch.zeros(1000,
                                                        dtype=torch.bool))):
        out = masked_kahan_sum(v, m)
        assert out.dtype == torch.float64 and float(out) == 0.0


# 96,075,776 rows: the SF 16 lineitem plate of the in-HBM Q6
@pytest.mark.parametrize("n", [0, 1, 3, 4_194_304, 8_388_608, 96_075_776])
@pytest.mark.parametrize("sms,per_sm", [(132, 8), (132, 3), (1, 1)])
def test_kahan_launch_plan(n, sms, per_sm):
    blocks, threads, steps = kr.kahan_launch_plan(n, sms, per_sm)
    n4 = n // 4
    assert 1 <= blocks <= sms * per_sm
    # the float4 steps cover the input, and none of the threads idles
    # below its minimum once the grid has more than one block
    assert blocks * threads * steps >= n4
    if blocks > 1:
        assert n4 >= blocks * threads * kr._MIN_STEPS
    if n4 < threads * kr._MIN_STEPS:
        assert blocks == 1
    if n >= 8_388_608 and sms * per_sm > 1:
        assert blocks > 1


@pytest.mark.parametrize("v_off,m_off,want", [
    (0, 0, (True, 0)), (1, 1, (True, 3)), (2, 2, (True, 2)),
    (3, 3, (True, 1)), (1, 0, (False, 0)), (0, 2, (False, 0))])
def test_kahan_layout_peels_to_the_vector_loop(v_off, m_off, want):
    """Value and mask views at row offsets from 16- and 4-byte aligned
    bases: offsets that agree modulo 4 rows peel a head and take the
    float4 loop, others read every row alone."""
    n = 1001
    vector, head, n4 = kr.kahan_layout(n, 4096 + 4 * v_off, 64 + m_off)
    assert (vector, head) == want
    if vector:
        assert (4096 + 4 * (v_off + head)) % 16 == 0
        assert (64 + m_off + head) % 4 == 0
        assert n4 == (n - head) // 4
    else:
        assert n4 == 0
    assert kr.kahan_layout(2, 4100, 1) == (True, 2, 0)


# --- grouped_reduce --------------------------------------------------------

def _jax_grouped(ops, gidx, G):
    return jax_grouped(
        [(k, None if v is None else jnp.asarray(v), jnp.asarray(m))
         for k, v, m in ops], jnp.asarray(gidx), G)


def _port_grouped(ops, gidx, G):
    return gr.grouped_reduce(
        [(k, None if v is None else _t(v), _t(m)) for k, v, m in ops],
        _t(gidx.astype(np.int32)), G)


def test_grouped_all_kinds_vs_oracle():
    rng = np.random.default_rng(0)
    n = 131_072
    G = 7
    gidx = rng.integers(0, G, n)
    v1 = (rng.random(n) * 2e4).astype(np.float32)  # same-sign
    v2 = (rng.random(n) * 100 - 50).astype(np.float32)
    m1 = rng.random(n) < 0.9
    m2 = rng.random(n) < 0.7
    ops = [("sum", v1, m1), ("count", None, m1), ("min", v2, m2),
           ("max", v2, m2), ("sum", v2, m2)]
    got = _port_grouped(ops, gidx, G)
    ref = _jax_grouped(ops, gidx, G)
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.int64
    assert got[2].dtype == torch.float32
    for g in range(G):
        s1 = (gidx == g) & m1
        s2 = (gidx == g) & m2
        exact = v1.astype(np.float64)[s1].sum()
        for out in (got, ref):
            assert float(out[0][g]) == pytest.approx(exact, rel=1e-7)
            assert int(out[1][g]) == int(s1.sum())
            assert float(out[2][g]) == v2[s2].min()
            assert float(out[3][g]) == v2[s2].max()
            exact2 = v2.astype(np.float64)[s2].sum()
            assert abs(float(out[4][g]) - exact2) \
                <= 1e-6 * np.abs(v2[s2].astype(np.float64)).sum()


@pytest.mark.parametrize("n", [1, 7, 1024, 131073])
def test_grouped_padding_and_empty_groups(n):
    rng = np.random.default_rng(1 + n)
    G = 5
    # group 4 stays empty: min/max keep the +/-inf fillers
    gidx = rng.integers(0, 4, n)
    v = (rng.random(n) * 10).astype(np.float32)
    m = np.ones(n, dtype=bool)
    ops = [("sum", v, m), ("count", None, m), ("min", v, m),
           ("max", v, m)]
    got = _port_grouped(ops, gidx, G)
    ref = _jax_grouped(ops, gidx, G)
    for out in (got, ref):
        assert float(out[0][4]) == 0.0
        assert int(out[1][4]) == 0
        assert float(out[2][4]) == np.inf
        assert float(out[3][4]) == -np.inf
    for g in range(4):
        sel = gidx == g
        if not sel.any():
            continue
        exact = v.astype(np.float64)[sel].sum()
        assert float(got[0][g]) == pytest.approx(exact, rel=1e-7, abs=1e-6)
        assert float(got[0][g]) == pytest.approx(float(ref[0][g]),
                                                 rel=1e-6, abs=1e-6)
        assert int(got[1][g]) == int(ref[1][g]) == int(sel.sum())
        assert float(got[2][g]) == float(ref[2][g]) == v[sel].min()
        assert float(got[3][g]) == float(ref[3][g]) == v[sel].max()


def test_grouped_overflow_segment_is_isolated():
    """The executor points invalid rows at segment G-1 (its +1 overflow
    segment); those rows must not leak into the real groups."""
    rng = np.random.default_rng(5)
    n = 4096
    G = 4
    gidx = rng.integers(0, G, n)
    v = (rng.random(n) * 10).astype(np.float32)
    m = rng.random(n) < 0.8
    got = _port_grouped([("sum", v, m), ("count", None, m)], gidx, G)
    for g in range(G - 1):
        sel = (gidx == g) & m
        assert float(got[0][g]) == pytest.approx(
            v.astype(np.float64)[sel].sum(), rel=1e-7)
        assert int(got[1][g]) == int(sel.sum())


def _q1_ops():
    """Q1's op list as the executor hands it to the kernel on the card:
    4 sums over 3 distinct value columns and 4 counts over one mask, plus
    the gvalid count over the same mask."""
    rng = np.random.default_rng(3)
    n = 4096
    m = torch.from_numpy(rng.random(n) < 0.9)
    qty, price, disc = (torch.from_numpy(rng.random(n).astype(np.float32))
                        for _ in range(3))
    ops = [("sum", qty, m), ("sum", price, m), ("sum", disc, m),
           ("sum", price, m), ("count", None, m), ("count", None, m),
           ("count", None, m), ("count", None, m), ("count", None, m)]
    gidx = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    return ops, gidx


def test_smem_budget_matches_kernel_layout():
    # one word per chain plus a Kahan compensation per sum, per group and
    # thread, at the kernel's compile-time 128 threads
    assert gr.op_smem_bytes("sum", 9) == 2 * 9 * gr.THREADS * 4
    assert gr.op_smem_bytes("count", 9) == 9 * gr.THREADS * 4
    # Q1's 9 ops are 4 chains after dedup (3 sums, 1 count): 7 words, not
    # the 12 + 1 of one chain per op
    ops, gidx = _q1_ops()
    firsts, _ = gr.chain_plan([gr.op_key(o) for o in ops],
                              [o[0] == "sum" for o in ops])
    chains = [ops[i] for i in firsts]
    spec, words, aligned = gr.pack_group_spec(chains, gidx.numel(), 9,
                                              gidx.device)
    assert (spec.ch.n, spec.ch.n_sums, words) == (4, 3, 7)
    assert words * 9 * gr.THREADS * 4 == sum(
        gr.op_smem_bytes(k, 9) for k, _v, _m in chains) <= gr.SMEM_BUDGET
    # 64 segments of 8 sums do not fit: the executor stops fusing before
    assert 8 * gr.op_smem_bytes("sum", 64) > gr.SMEM_BUDGET


def test_chain_plan_dedups_in_caller_order():
    ops, gidx = _q1_ops()
    firsts, where = gr.chain_plan([gr.op_key(o) for o in ops],
                                  [o[0] == "sum" for o in ops])
    # sums first, then the one count; duplicates point at the first copy
    assert [ops[i][0] for i in firsts] == ["sum", "sum", "sum", "count"]
    assert where == [0, 1, 2, 1, 3, 3, 3, 3, 3]
    # the wrapper's results, one per caller position, equal the plain
    # version run on every op without dedup
    got = gr.grouped_reduce(ops, gidx, 9)
    want = gr.grouped_reduce_plain(ops, gidx, 9)
    assert len(got) == len(ops)
    for (k, _v, _m), a, b in zip(ops, got, want):
        assert a.dtype == b.dtype
        if k == "sum":
            assert torch.allclose(a, b, rtol=1e-7, atol=0)
        else:
            assert torch.equal(a, b)


def test_chain_plan_keeps_distinct_kinds_apart():
    # the same column and mask under sum, min and max are three chains;
    # a count ignores its values
    v = torch.ones(8)
    m = torch.ones(8, dtype=torch.bool)
    ops = [("max", v, m), ("sum", v, m), ("min", v, m), ("count", v, m),
           ("count", None, m), ("sum", v, m)]
    firsts, where = gr.chain_plan([gr.op_key(o) for o in ops],
                                  [o[0] == "sum" for o in ops])
    assert [ops[i][0] for i in firsts] == ["sum", "max", "min", "count"]
    assert where == [1, 0, 2, 3, 3, 0]


def test_group_spec_packing():
    # the ctypes mirror of csrc/group_reduce.cu GroupSpec: gp::Chains (3
    # ints + 32 kinds = 140 bytes, padded to 144), then 32 value and 32
    # mask pointers; passed by value, far under the 4 KB parameter limit
    assert ctypes.sizeof(gr._Chains) == 140
    assert gr._GroupSpec.values.offset == 144
    assert gr._GroupSpec.masks.offset == 144 + 8 * gr.MAX_OPS
    assert ctypes.sizeof(gr._GroupSpec) == 144 + 16 * gr.MAX_OPS < 4096
    m = torch.ones(16, dtype=torch.bool)
    vals = [torch.ones(16) for _ in range(gr.MAX_OPS + 1)]
    spec, words, _ = gr.pack_group_spec(
        [("sum", vals[0], m), ("min", vals[1], m), ("count", None, m)], 16,
        5, m.device)
    assert (spec.ch.n, spec.ch.n_sums, spec.ch.G, words) == (3, 1, 5, 4)
    assert list(spec.ch.kind[:3]) == [0, 2, 1]
    assert spec.values[0] == vals[0].data_ptr() and spec.values[2] is None
    assert spec.masks[2] == m.data_ptr()
    with pytest.raises(ValueError):
        gr.pack_group_spec([("sum", v, m) for v in vals], 16, 5, m.device)
    with pytest.raises(TypeError):
        gr.pack_group_spec([("sum", torch.ones(15), m)], 16, 5, m.device)
    with pytest.raises(TypeError):
        gr.pack_group_spec([("sum", torch.ones(16, dtype=torch.float64),
                             m)], 16, 5, m.device)


def test_grouped_rejects_bad_shapes():
    g = torch.zeros(4, dtype=torch.int32)
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        gr.grouped_reduce([("sum", torch.ones(4), m)], g, gr.MAX_GROUPS + 1)
    with pytest.raises(ValueError):
        gr.grouped_reduce([("median", torch.ones(4), m)], g, 2)


def test_wrappers_refuse_other_devices():
    v = torch.ones(4, device="meta")
    m = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        masked_kahan_sum(v, m)
    with pytest.raises(RuntimeError):
        gr.grouped_reduce([("count", None, m)],
                          torch.zeros(4, dtype=torch.int32, device="meta"), 2)


def test_kernel_library_is_stale_after_a_shared_header_changes(
        tmp_path, monkeypatch):
    """A library rebuilds when its source or any csrc/*.cuh is newer."""
    import os

    from snappydata_tpu_torch.ops import cuda_build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD", str(build))
    (csrc / "k.cu").write_text("// kernel")
    header = csrc / "shared.cuh"
    header.write_text("// header")
    assert cuda_build._stale("k")          # never built
    lib = build / "libk.so"
    lib.write_text("")
    os.utime(csrc / "k.cu", (100, 100))
    os.utime(header, (100, 100))
    os.utime(lib, (200, 200))
    assert not cuda_build._stale("k")
    os.utime(header, (300, 300))            # the header moved on
    assert cuda_build._stale("k")
