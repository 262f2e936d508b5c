"""The port's code-domain kernels against the JAX package's Pallas kernels.

`fused_code_filter_sum` (the Q6 shape) and `grouped_code_reduce` (the Q1
shape) get the same numpy inputs, made from a seed, through the JAX
kernels (interpret mode on the CPU, as the JAX package's own tests run
them) and through the port's wrappers on CPU tensors, which run the
kernels' plain PyTorch versions.  Tolerances: counts exact; sums within
1e-6 * sum(|v|) of a float64 oracle, and the port within rel 1e-7 of the
JAX kernel (all sums here are same-sign).

The CUDA kernels themselves are held against their plain versions in
tests/test_torch_cuda.py, on the card.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappydata_tpu.ops.pallas_group import grouped_code_reduce as jax_gcr
from snappydata_tpu.ops.pallas_reduce import fused_code_filter_sum as jax_fcs
from snappydata_tpu_torch.ops import group_reduce as gr
from snappydata_tpu_torch.ops import kahan_reduce as kr

SLO, SHI = 8500, 9200


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _q6_inputs(rng, B, cap, code_dtype, D):
    """Q6-shaped plates; the last batch is a padded one (no rows, a zero
    dictionary, zero thresholds)."""
    qty = rng.integers(0, D, (B, cap)).astype(code_dtype)
    disc = rng.integers(0, D, (B, cap)).astype(code_dtype)
    ship = rng.integers(8000, 9700, (B, cap)).astype(np.int32)
    price = (rng.random((B, cap)) * 1e4).astype(np.float32)
    valid = rng.random((B, cap)) < 0.9
    dicts = np.sort(rng.random((B, D)), axis=1).astype(np.float32)
    qhi = rng.integers(D // 4, D + 1, B).astype(np.int32)
    dlo = rng.integers(0, D // 2, B).astype(np.int32)
    dhi = (dlo + rng.integers(0, D // 2, B)).astype(np.int32)
    valid[-1] = False
    dicts[-1] = 0.0
    qhi[-1] = dlo[-1] = dhi[-1] = 0
    return qty, disc, ship, price, valid, dicts, qhi, dlo, dhi


def _q6_oracle(qty, disc, ship, price, valid, dicts, qhi, dlo, dhi):
    ok = (valid & (qty.astype(np.int64) < qhi[:, None])
          & (disc >= dlo[:, None]) & (disc <= dhi[:, None])
          & (ship >= SLO) & (ship < SHI))
    dval = np.take_along_axis(dicts.astype(np.float64),
                              disc.astype(np.int64), axis=1)
    v = price.astype(np.float64) * dval
    return float(v[ok].sum()), int(ok.sum()), float(np.abs(v[ok]).sum())


def _run_q6(inputs):
    port = kr.fused_code_filter_sum(*[_t(a) for a in inputs], SLO, SHI)
    ref = jax_fcs(*[jnp.asarray(a) for a in inputs], SLO, SHI)
    return (float(port[0]), int(port[1])), (float(ref[0]), int(ref[1]))


# cap 1000 is a multiple of neither 128 nor the JAX block; uint16 codes
# with a dictionary wider than 256
@pytest.mark.parametrize("code_dtype,D,cap", [(np.uint8, 16, 1000),
                                              (np.uint16, 300, 1000),
                                              (np.uint8, 64, 2048)])
def test_code_filter_sum_matches_jax(code_dtype, D, cap):
    rng = np.random.default_rng(21 + D)
    inputs = _q6_inputs(rng, 3, cap, code_dtype, D)
    exact, count, scale = _q6_oracle(*inputs)
    (got, got_n), (ref, ref_n) = _run_q6(inputs)
    assert got_n == ref_n == count > 0
    assert abs(got - exact) <= 1e-6 * scale
    assert abs(ref - exact) <= 1e-6 * scale
    assert got == pytest.approx(ref, rel=1e-7)


def test_code_filter_sum_thresholds_match_nothing():
    rng = np.random.default_rng(5)
    qty, disc, ship, price, valid, dicts, qhi, dlo, dhi = _q6_inputs(
        rng, 3, 1000, np.uint8, 16)
    # dlo > dhi in every batch: the literal range held no dictionary code
    dlo[:] = 9
    dhi[:] = 8
    (got, got_n), (ref, ref_n) = _run_q6(
        (qty, disc, ship, price, valid, dicts, qhi, dlo, dhi))
    assert got == ref == 0.0 and got_n == ref_n == 0


def test_code_filter_sum_results_are_float64_and_int64():
    rng = np.random.default_rng(6)
    inputs = _q6_inputs(rng, 2, 64, np.uint8, 8)
    total, count = kr.fused_code_filter_sum(*[_t(a) for a in inputs],
                                            SLO, SHI)
    assert total.dtype == torch.float64 and total.dim() == 0
    assert count.dtype == torch.int64 and count.dim() == 0


# --- grouped_code_reduce ---------------------------------------------------

def _gcr_case(rng, B, cap, G):
    gidx = rng.integers(0, G, (B, cap)).astype(np.int32)
    mask = rng.random((B, cap)) < 0.85
    mask[-1] = False                           # the padded batch
    plain = (rng.random((B, cap)) * 1e4).astype(np.float32)
    c8 = rng.integers(0, 16, (B, cap)).astype(np.uint8)
    c16 = rng.integers(0, 300, (B, cap)).astype(np.uint16)
    d8 = (rng.random((B, 16)) + 0.5).astype(np.float32)
    d16 = (rng.random((B, 300)) + 0.5).astype(np.float32)
    return gidx, mask, plain, c8, c16, d8, d16


def _gcr_slots(plain, c8, c16, d8, d16):
    # a count; a slot without factors; a slot without a plain column;
    # two slots that share one code plate and its dictionary; a uint16
    # factor
    return [("count",),
            ("sum", plain, []),
            ("sum", None, [(c8, d8)]),
            ("sum", plain, [(c8, d8)]),
            ("sum", plain, [(c8, d8), (c16, d16)])]


def _gcr_oracle(gidx, mask, slots, G):
    out = []
    for slot in slots:
        if slot[0] == "count":
            out.append((np.bincount(gidx[mask], minlength=G), None))
            continue
        _, plain, factors = slot
        v = plain.astype(np.float64) if plain is not None \
            else np.ones(gidx.shape)
        for codes, dicts in factors:
            v = v * np.take_along_axis(dicts.astype(np.float64),
                                       codes.astype(np.int64), axis=1)
        out.append((np.bincount(gidx[mask], weights=v[mask], minlength=G),
                    np.bincount(gidx[mask], weights=np.abs(v[mask]),
                                minlength=G)))
    return out


def _run_gcr(gidx, mask, slots, G):
    cache = {}

    def port_arr(a):            # one tensor per array: dedup by identity
        return cache.setdefault(id(a), _t(a))

    def port_slots(f):
        return [s if s[0] == "count" else
                ("sum", None if s[1] is None else f(s[1]),
                 [(f(c), f(d)) for c, d in s[2]]) for s in slots]

    got = gr.grouped_code_reduce(port_arr(gidx), port_arr(mask),
                                 port_slots(port_arr), G)
    jcache = {}
    ref = jax.block_until_ready(jax_gcr(
        jnp.asarray(gidx), jnp.asarray(mask),
        port_slots(lambda a: jcache.setdefault(id(a), jnp.asarray(a))), G))
    return got, ref


@pytest.mark.parametrize("G,cap", [(1, 1000), (6, 1000), (64, 2048)])
def test_grouped_code_reduce_matches_jax(G, cap):
    rng = np.random.default_rng(40 + G)
    gidx, mask, plain, c8, c16, d8, d16 = _gcr_case(rng, 3, cap, G)
    slots = _gcr_slots(plain, c8, c16, d8, d16)
    got, ref = _run_gcr(gidx, mask, slots, G)
    want = _gcr_oracle(gidx, mask, slots, G)
    assert got[0].dtype == torch.int64
    assert got[1].dtype == torch.float64
    for k, (exact, scale) in enumerate(want):
        g_k = got[k].numpy()
        r_k = np.asarray(ref[k])
        if scale is None:
            assert (g_k == exact).all() and (r_k == exact).all()
            continue
        assert (np.abs(g_k - exact) <= 1e-6 * scale).all(), k
        assert (np.abs(r_k - exact) <= 1e-6 * scale).all(), k
        assert g_k == pytest.approx(r_k, rel=1e-7), k


def test_grouped_code_reduce_rows_outside_groups_count_nowhere():
    """Rows whose group index lies outside [0, G) add to no group, in
    both packages."""
    rng = np.random.default_rng(8)
    gidx, mask, plain, c8, c16, d8, d16 = _gcr_case(rng, 2, 512, 4)
    gidx[0, :100] = 7
    slots = [("count",), ("sum", plain, [(c8, d8)])]
    got, ref = _run_gcr(gidx, mask, slots, 4)
    inside = mask & (gidx < 4)
    assert int(got[0].sum()) == int(np.asarray(ref[0]).sum()) \
        == int(inside.sum())


def test_code_kernel_threads_follow_the_smem_budget():
    # Q1: one count and four Kahan sums, all distinct: 5 words of primary
    # partials + 4 compensations = 9 per group and thread, over 6 groups
    rng = np.random.default_rng(11)
    gidx, mask, plain, c8, c16, d8, d16 = (
        _t(a) for a in _gcr_case(rng, 2, 64, 6))
    q1 = [("count",), ("sum", None, [(c8, d8)]), ("sum", plain, []),
          ("sum", plain, [(c8, d8)]), ("sum", plain, [(c8, d8), (c16, d16)])]
    assert gr.code_words(q1) == 9
    spec, words, dict_bytes, _, _ = gr.pack_code_spec(gidx, mask, q1, 6)
    assert words == 9 and dict_bytes == 4 * (256 + 300)
    assert gr.code_threads(9, 6) == 128
    assert gr.code_smem_bytes(9, 6, 128) == 9 * 6 * 128 * 4
    # the same slots over 64 groups need 295 KB at 128 threads
    assert gr.code_smem_bytes(9, 64, 128) > gr.SMEM_BUDGET
    assert gr.code_threads(9, 64) == 64
    # one warp is the floor: 25 sums over 64 groups exceed it
    assert gr.code_threads(50, 64) is None


def test_code_slot_dedup_in_caller_order():
    rng = np.random.default_rng(12)
    gidx, mask, plain, c8, c16, d8, d16 = (
        _t(a) for a in _gcr_case(rng, 3, 1000, 6))
    slots = [("sum", plain, [(c8, d8)]), ("count",),
             ("sum", plain, [(c8, d8)]), ("sum", None, [(c16, d16)]),
             ("count",), ("sum", plain, [(c8, d8), (c16, d16)]),
             ("sum", plain, [(c16, d16), (c8, d8)])]
    firsts, where = gr.chain_plan([gr.slot_key(s) for s in slots],
                                  [s[0] == "sum" for s in slots])
    # factor order is part of a slot's identity (the products round in it)
    assert firsts == [0, 3, 5, 6, 1]
    assert where == [0, 4, 0, 1, 4, 2, 3]
    got = gr.grouped_code_reduce(gidx, mask, slots, 6)
    want = gr.grouped_code_reduce_plain(gidx, mask, slots, 6)
    assert len(got) == len(slots)
    for slot, a, b in zip(slots, got, want):
        assert a.dtype == b.dtype
        if slot[0] == "count":
            assert torch.equal(a, b)
        else:
            assert torch.allclose(a, b, rtol=1e-7, atol=0)


def test_code_spec_packing():
    # the ctypes mirror of csrc/group_code_reduce.cu CodeSpec, passed by
    # value: gp::Chains (144 with padding), two pointers, cap, B, n_dicts,
    # per slot a plain pointer, a factor count, an extra-factor start and
    # CODE_HOIST 32-byte factors, MAX_CODE_EXTRA extra factors, then the
    # distinct dictionaries for the shared-memory reload
    assert ctypes.sizeof(gr._Factor) == 32
    assert gr._CodeSpec.gidx.offset == 144
    assert gr._CodeSpec.plain.offset == 176
    assert gr._CodeSpec.factor.offset == 176 + 16 * gr.MAX_CODE_SLOTS
    assert gr._CodeSpec.extra.offset == gr._CodeSpec.factor.offset \
        + 32 * gr.CODE_HOIST * gr.MAX_CODE_SLOTS
    assert ctypes.sizeof(gr._CodeSpec) == 2096 < 4096
    rng = np.random.default_rng(13)
    gidx, mask, plain, c8, c16, d8, d16 = (
        _t(a) for a in _gcr_case(rng, 2, 64, 6))
    chains = [("sum", plain, [(c8, d8), (c16, d16)]),
              ("sum", None, [(c8, d8)]), ("count",)]
    spec, words, dict_bytes, vec, keep = gr.pack_code_spec(
        gidx, mask, chains, 6)
    assert (spec.ch.n, spec.ch.n_sums, spec.ch.G, words) == (3, 2, 6, 5)
    assert list(spec.ch.kind[:3]) == [0, 0, 1]
    assert (spec.B, spec.cap, spec.n_dicts) == (2, 64, 2)
    assert spec.plain[0] == plain.data_ptr() and spec.plain[1] is None
    assert list(spec.n_factors[:2]) == [2, 1]
    f00, f01, f10 = spec.factor[0][0], spec.factor[0][1], spec.factor[1][0]
    assert (f00.codes, f00.dict, f00.code_bytes) == (
        c8.data_ptr(), d8.data_ptr(), 1)
    # rows padded to 256 entries in shared memory
    assert (f01.code_bytes, f01.dict_w, f01.dict_off) == (2, 300, 256)
    assert (f10.codes, f10.dict_w, f10.dict_off) == (c8.data_ptr(), 16, 0)
    assert list(spec.dict_w[:2]) == [16, 300]
    assert dict_bytes == 4 * (256 + 300) and vec
    # the limits: distinct slots, distinct dictionaries, extra factors
    many = [("sum", _t(rng.random((2, 64)).astype(np.float32)), [])
            for _ in range(gr.MAX_CODE_SLOTS + 1)]
    with pytest.raises(ValueError):
        gr.pack_code_spec(gidx, mask, many, 6)
    own = [("sum", None, [(c8, _t(rng.random((2, 16)).astype(np.float32)))])
           for _ in range(gr.MAX_CODE_DICTS + 1)]
    gr.pack_code_spec(gidx, mask, own[:-1], 6)
    with pytest.raises(ValueError):
        gr.pack_code_spec(gidx, mask, own, 6)
    long = [("sum", None, [(c8, d8)] * 9) for _ in range(3)]
    gr.pack_code_spec(gidx, mask, long[:2], 6)      # 14 extra factors
    with pytest.raises(ValueError):
        gr.pack_code_spec(gidx, mask, long, 6)      # 21
    with pytest.raises(TypeError):
        gr.pack_code_spec(gidx, mask, [("sum", plain.double(), [])], 6)


@pytest.mark.parametrize("B,cap,threads,blocks", [
    (768, 131072, 128, 924),   # the main path: 196,608 tiles
    (5000, 64, 128, 924),      # many small batches: B > grid
    (3, 1001, 32, 924),        # fewer tiles than blocks would allow
    (1, 4096, 64, 7)])
def test_code_tile_walk_covers_every_tile_once(B, cap, threads, blocks):
    chunks = gr.code_chunks(cap, threads)
    total = B * chunks
    blocks = min(blocks, total)   # the wrapper's grid
    seen = []
    for blk in range(blocks):
        lo, hi = gr.tile_range(blk, blocks, total)
        assert hi - lo in (total // blocks, -(-total // blocks))
        walked = list(range(lo, hi))
        seen.extend(walked)
        # a block reloads the dictionaries once per batch it enters
        batches = {t // chunks for t in walked}
        assert len(batches) <= -(-(hi - lo) // chunks) + 1
    assert seen == list(range(total))
    # every (batch, chunk) pair is one tile, rows 4 * threads each
    assert {(t // chunks, t % chunks) for t in seen} == {
        (b, c) for b in range(B) for c in range(chunks)}
    assert chunks * 4 * threads >= cap > (chunks - 1) * 4 * threads


def test_grouped_code_reduce_rejects_bad_slots():
    g = torch.zeros((1, 4), dtype=torch.int32)
    m = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        gr.grouped_code_reduce(g, m, [("count",)], gr.MAX_GROUPS + 1)
    with pytest.raises(ValueError):
        gr.grouped_code_reduce(g, m, [("min", None, [])], 2)
    with pytest.raises(ValueError):
        gr.grouped_code_reduce(g, m, [], 2)


def test_code_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    codes = torch.zeros((1, 4), dtype=torch.uint8, device=meta)
    i32 = torch.zeros((1, 4), dtype=torch.int32, device=meta)
    f32 = torch.zeros((1, 4), dtype=torch.float32, device=meta)
    b = torch.zeros((1, 4), dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError):
        kr.fused_code_filter_sum(codes, codes, i32, f32, b, f32, [0], [0],
                                 [0], 0, 1)
    with pytest.raises(RuntimeError):
        gr.grouped_code_reduce(i32, b, [("count",)], 2)
