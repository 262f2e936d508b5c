// Fused grouped SUM / COUNT / MIN / MAX over float32 values, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel snappydata_tpu/ops/pallas_group.py
// grouped_reduce (kernel from _make_kernel): one streaming pass that
// computes every fused aggregate slot of a dictionary-keyed GROUP BY
// (G <= 64 groups, the executor's +1 overflow segment included).  Sums
// keep a Kahan compensation per chain, counts are exact integers,
// MIN/MAX start from +/-inf so an empty group keeps the filler.
//
// Bound on this card: bytes.  Per row the kernel reads the 4 B group
// index plus 4 B per distinct value input and 1 B per distinct mask, and
// does a handful of f32 adds per chain; HBM bandwidth (3.35 TB/s) is the
// limit, not arithmetic.  What stood between the first design and that
// bound was shared memory: every word of every slot was its own dependent
// load -> update -> store, and identical slots each had their chains.
// Design:
//   - The wrapper hands the kernel distinct chains only: slots with the
//     same (kind, values, mask) share one chain, sums first.  Q1 goes from
//     12 partial words per row to 7.
//   - The chains live in shared memory in group_partials.cuh's layout:
//     one private column per thread, a sum's (s, c) pair read and written
//     with one 64-bit access, T = 128 threads a compile-time constant, no
//     races, no atomics, no bank conflicts for any group mix.  The chain
//     count is a compile-time bucket KB (2, 4, 8, 16, 32; chains past the
//     real count are predicated off), so one row reads all of its words,
//     updates them in registers and writes them back: one shared-memory
//     round trip per row.  Buckets up to 8 are held to 72 registers, so
//     Q1's 32 KB layout runs 7 blocks (28 warps) per SM.
//   - The spec (kinds, pointers) is a struct passed by value as a
//     __grid_constant__ parameter: no upload per call, and its reads in
//     the row loop are uniform constant-bank loads.
//   - Rows are read in a grid-stride loop over a persistent grid (resident
//     blocks per SM from the occupancy API, times the SMs), four rows per
//     thread and step with 16-byte loads for KB <= 8 (a scalar loop takes
//     larger buckets, the ragged tail and unaligned inputs).
//   - Each block folds its columns into part[chain, group, block] and one
//     combine kernel, launched right behind, writes the final [chains, G]
//     rows in their own types: one step after the kernel, not one per op.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math (it would let the compiler
// cancel the Kahan compensation).

#include <cstdint>
#include <cuda_runtime.h>

#include "group_partials.cuh"

// at namespace scope: the extern "C" entry points below take it
struct GroupSpec {
    gp::Chains ch;                               // sums first
    const float *values[gp::kMaxChains];         // null for a count
    const uint8_t *masks[gp::kMaxChains];
};

namespace {

constexpr int kThreads = 128;

// blocks per SM the register budget must allow: 7 x 128 threads is the
// most the Q1 layout (32 KB of partials) fits, so the small buckets are
// held to 72 registers
template <int KB>
constexpr int min_blocks() { return KB <= 8 ? 7 : 1; }

// row j of the step into the thread's own column of group g: every word
// read, updated in registers, written back.  m[k] holds chain k's mask
// bytes of the step, row j in byte j.
template <int KB, int R>
__device__ __forceinline__ void row_update(float *sm, const gp::Chains &ch,
                                           int W, int g,
                                           const float (&v)[KB][R],
                                           const unsigned (&m)[KB], int j) {
    if (g < 0 || g >= ch.G) return;
    float2 *pr = gp::pairs_of<kThreads>(sm, W, g);
    float *sg = gp::singles_of<kThreads>(sm, W, g, ch.n_sums);
    float s[KB], c[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        if (k < ch.n_sums) {
            const float2 x = pr[k * kThreads];
            s[k] = x.x;
            c[k] = x.y;
        } else if (k < ch.n) {
            s[k] = sg[k * kThreads];
        }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        if (k >= ch.n || !((m[k] >> (8 * j)) & 0xffu)) continue;
        if (k < ch.n_sums) {
            gp::kahan(s[k], c[k], v[k][j]);
        } else if (ch.kind[k] == gp::kCount) {
            s[k] = gp::count_add(s[k]);
        } else if (ch.kind[k] == gp::kMin) {
            s[k] = gp::nan_min(v[k][j], s[k]);
        } else {
            s[k] = gp::nan_max(v[k][j], s[k]);
        }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        if (k >= ch.n || !((m[k] >> (8 * j)) & 0xffu)) continue;
        if (k < ch.n_sums) {
            pr[k * kThreads] = make_float2(s[k], c[k]);
        } else {
            sg[k * kThreads] = s[k];
        }
    }
}

template <int KB>
__global__ void __launch_bounds__(kThreads, min_blocks<KB>())
group_reduce_kernel(const int32_t *__restrict__ gidx, long long n,
                    const __grid_constant__ GroupSpec spec, int vec,
                    double *__restrict__ part) {
    extern __shared__ float sm[];
    const gp::Chains &ch = spec.ch;
    const int W = ch.n + ch.n_sums;
    gp::init_column<kThreads>(sm, ch);
    // each thread owns its column: no barrier needed before the loop

    const long long stride = (long long)gridDim.x * kThreads;
    const long long first = blockIdx.x * (long long)kThreads + threadIdx.x;
    long long done = 0;
    if constexpr (KB <= 8) {
        if (vec) {
            // four rows per step: int4 of group index, uchar4 of each mask,
            // float4 of each value input, all in flight together
            const long long n4 = n / 4;
            for (long long q = first; q < n4; q += stride) {
                const int4 g4 = reinterpret_cast<const int4 *>(gidx)[q];
                float v[KB][4];
                unsigned m[KB];
#pragma unroll
                for (int k = 0; k < KB; ++k) {
                    if (k >= ch.n) continue;
                    m[k] = reinterpret_cast<const unsigned *>(
                        spec.masks[k])[q];
                    if (ch.kind[k] != gp::kCount) {
                        const float4 x = reinterpret_cast<const float4 *>(
                            spec.values[k])[q];
                        v[k][0] = x.x; v[k][1] = x.y;
                        v[k][2] = x.z; v[k][3] = x.w;
                    }
                }
                row_update<KB, 4>(sm, ch, W, g4.x, v, m, 0);
                row_update<KB, 4>(sm, ch, W, g4.y, v, m, 1);
                row_update<KB, 4>(sm, ch, W, g4.z, v, m, 2);
                row_update<KB, 4>(sm, ch, W, g4.w, v, m, 3);
            }
            done = n4 * 4;
        }
    }
    for (long long r = done + first; r < n; r += stride) {
        float v[KB][1];
        unsigned m[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) {
            if (k >= ch.n) continue;
            m[k] = spec.masks[k][r];
            if (ch.kind[k] != gp::kCount) v[k][0] = spec.values[k][r];
        }
        row_update<KB, 1>(sm, ch, W, gidx[r], v, m, 0);
    }
    __syncthreads();
    gp::fold_block<kThreads>(sm, ch, part);
}

template <int KB>
int launch(const int32_t *gidx, long long n, const GroupSpec &spec, int vec,
           double *part, int blocks, double *out, long long smem,
           cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        group_reduce_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    group_reduce_kernel<KB><<<blocks, kThreads, static_cast<size_t>(smem),
                              stream>>>(gidx, n, spec, vec, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(gp::launch_combine(part, blocks, spec.ch, out,
                                               stream));
}

}  // namespace

// `spec` points at a host GroupSpec (sums first), copied into the kernel's
// parameters.  kb is the chain bucket (2, 4, 8, 16 or 32, >= spec->ch.n).
// `vec` is nonzero when gidx and every value input are 16-byte aligned and
// every mask 4-byte aligned.  part holds n * G * blocks doubles of scratch;
// out receives the [n, G] final rows (8-byte cells: float64 sums, int64
// counts, float32 min/max in the first G floats of the row).  Launches the
// kernel and the combine on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int group_reduce_f32(const void *gidx, long long n,
                                const GroupSpec *spec, int kb, int vec,
                                void *part, int blocks, void *out,
                                long long smem_bytes, void *stream) {
    const int32_t *g = static_cast<const int32_t *>(gidx);
    double *p = static_cast<double *>(part);
    double *o = static_cast<double *>(out);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch (kb) {
        case 2: return launch<2>(g, n, *spec, vec, p, blocks, o, smem_bytes, s);
        case 4: return launch<4>(g, n, *spec, vec, p, blocks, o, smem_bytes, s);
        case 8: return launch<8>(g, n, *spec, vec, p, blocks, o, smem_bytes, s);
        case 16: return launch<16>(g, n, *spec, vec, p, blocks, o, smem_bytes, s);
        case 32: return launch<32>(g, n, *spec, vec, p, blocks, o, smem_bytes, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// resident blocks per SM of the bucket-kb kernel at smem_bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int group_reduce_occupancy(int kb, long long smem_bytes,
                                      int *per_sm) {
    switch (kb) {
        case 2: return gp::occupancy(group_reduce_kernel<2>, kThreads, smem_bytes, per_sm);
        case 4: return gp::occupancy(group_reduce_kernel<4>, kThreads, smem_bytes, per_sm);
        case 8: return gp::occupancy(group_reduce_kernel<8>, kThreads, smem_bytes, per_sm);
        case 16: return gp::occupancy(group_reduce_kernel<16>, kThreads, smem_bytes, per_sm);
        case 32: return gp::occupancy(group_reduce_kernel<32>, kThreads, smem_bytes, per_sm);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
