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
    # Q1: one count and four Kahan sums (9 words) over 6 groups
    assert gr.code_threads(9, 6) == 128
    # the same slots over 64 groups need 295 KB at 128 threads
    assert gr.code_smem_bytes(9, 64, 128) > gr.SMEM_BUDGET
    assert gr.code_threads(9, 64) == 64
    # one warp is the floor: 25 sums over 64 groups exceed it
    assert gr.code_threads(50, 64) is None


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
