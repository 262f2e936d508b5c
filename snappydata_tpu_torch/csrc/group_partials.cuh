// Partial chains shared by the two grouped-reduce kernels
// (group_reduce.cu, group_code_reduce.cu), for Hopper (sm_90a).
//
// Layout.  Each thread owns a private column of partial words in shared
// memory, W = n + n_sums floats per group and thread (n chains, sums
// first).  Group g's words start at float g * W * T (T threads per block,
// a compile-time constant); in them
//
//     sum k < n_sums:     the pair (s, c) at float2 k * T + t
//     chain k >= n_sums:  one word at float (n_sums + k) * T + t
//
// (a count's word is an int, a min's or max's a float).  A thread only
// touches its own column (no races, no atomics), and a warp's access is
// 32 consecutive 8-byte pairs or 32 consecutive words: two or one
// wavefronts, no bank conflicts whatever the group mix.
//
// One row's update reads all of its words first (one 64-bit load per
// sum), updates them in registers, then writes them back: the addresses
// are base + compile-time offsets (k unrolled), so the loads issue back to
// back and the row costs one shared-memory round trip, not one per word.
// Rows of one step run in order, since two of them may share a group.
//
// Chain kinds: 0 sum (f32 Kahan, combined in float64 as s - c), 1 count
// (exact int), 2 min, 3 max (seeded with +/-inf, NaN-propagating).
//
// After its last tile each block folds its T columns into one float64 per
// (chain, group), part[chain, group, block]; `combine_kernel` then sums
// (or takes the min / max of) the blocks in float64 in a fixed order, one
// block per (chain, group) reading its row of `part` coalesced, and
// writes each chain's final row in its own type into one [n, G] buffer of
// 8-byte cells: float64 sums, int64 counts, float32 min/max (the first G
// floats of the chain's row).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3.  Never
// --use_fast_math (it would let the compiler cancel the Kahan
// compensation).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace gp {

constexpr int kSum = 0;
constexpr int kCount = 1;
constexpr int kMin = 2;
constexpr int kMax = 3;

constexpr int kMaxChains = 32;

// the chains of one launch, sums first; part of each kernel's parameters
struct Chains {
    int n;       // chains
    int n_sums;  // chains [0, n_sums) are sums
    int G;       // groups
    int kind[kMaxChains];
};

// NaN-propagating min/max (fminf/fmaxf would drop a NaN; the plain
// version's torch.minimum/maximum keep it)
template <typename F>
__device__ __forceinline__ F nan_min(F a, F b) {
    return (a != a || a < b) ? a : b;
}
template <typename F>
__device__ __forceinline__ F nan_max(F a, F b) {
    return (a != a || a > b) ? a : b;
}

// one compensated step: (s, c) += v
__device__ __forceinline__ void kahan(float &s, float &c, float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
}

__device__ __forceinline__ float count_add(float s) {
    return __int_as_float(__float_as_int(s) + 1);
}

// thread t's (s, c) pairs of group g, and its single words (chain k >=
// n_sums at [k * T])
template <int T>
__device__ __forceinline__ float2 *pairs_of(float *sm, int W, int g) {
    return reinterpret_cast<float2 *>(sm + g * W * T) + threadIdx.x;
}
template <int T>
__device__ __forceinline__ float *singles_of(float *sm, int W, int g,
                                             int n_sums) {
    return sm + (g * W + n_sums) * T + threadIdx.x;
}

// this thread's words of every group to their seeds (a count's 0.0f is
// the int 0)
template <int T>
__device__ __forceinline__ void init_column(float *sm, const Chains &ch) {
    const int W = ch.n + ch.n_sums;
    for (int g = 0; g < ch.G; ++g) {
        float2 *pr = pairs_of<T>(sm, W, g);
        float *sg = singles_of<T>(sm, W, g, ch.n_sums);
        for (int k = 0; k < ch.n_sums; ++k) pr[k * T] = make_float2(0.f, 0.f);
        for (int k = ch.n_sums; k < ch.n; ++k) {
            const int kd = ch.kind[k];
            sg[k * T] = kd == kMin ? CUDART_INF_F
                                   : kd == kMax ? -CUDART_INF_F : 0.0f;
        }
    }
}

template <typename F>
__device__ __forceinline__ F merge(int kind, F acc, F x) {
    if (kind == kMin) return nan_min(x, acc);
    if (kind == kMax) return nan_max(x, acc);
    return acc + x;
}

__device__ __forceinline__ double seed64(int kind) {
    return kind == kMin ? CUDART_INF : kind == kMax ? -CUDART_INF : 0.0;
}

// fold the block's T columns, one warp per (chain, group) pair, into
// part[(k * G + g) * gridDim.x + blockIdx.x]; call after a __syncthreads()
template <int T>
__device__ __forceinline__ void fold_block(const float *sm, const Chains &ch,
                                           double *__restrict__ part) {
    const int W = ch.n + ch.n_sums;
    const int G = ch.G;
    const int lane = threadIdx.x & 31;
    for (int p = threadIdx.x >> 5; p < ch.n * G; p += T / 32) {
        const int k = p / G;
        const int g = p - k * G;
        const int kd = ch.kind[k];
        double acc = seed64(kd);
        if (kd == kSum) {
            const float2 *pr = reinterpret_cast<const float2 *>(
                sm + g * W * T) + k * T;
            for (int j = lane; j < T; j += 32) {
                acc += (double)pr[j].x - (double)pr[j].y;
            }
        } else {
            const float *sg = sm + (g * W + ch.n_sums + k) * T;
            for (int j = lane; j < T; j += 32) {
                acc = kd == kCount ? acc + (double)__float_as_int(sg[j])
                                   : merge(kd, acc, (double)sg[j]);
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            acc = merge(kd, acc, __shfl_down_sync(0xffffffffu, acc, off));
        }
        if (lane == 0) {
            part[((long long)k * G + g) * gridDim.x + blockIdx.x] = acc;
        }
    }
}

constexpr int kCombineThreads = 256;

// the blocks' partials of `part` [n, G, blocks] into out [n, G] (8-byte
// cells): one block per (chain, group), each thread a strided run of the
// blocks, then a fixed tree over the threads
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const double *__restrict__ part, int blocks,
               const __grid_constant__ Chains ch, double *__restrict__ out) {
    __shared__ double red[kCombineThreads / 32];
    const int G = ch.G;
    const int k = blockIdx.x / G;
    const int g = blockIdx.x - k * G;
    const int kd = ch.kind[k];
    const double *row = part + (long long)blockIdx.x * blocks;
    double acc = seed64(kd);
    for (int b = threadIdx.x; b < blocks; b += kCombineThreads) {
        acc = merge(kd, acc, row[b]);
    }
    for (int off = 16; off > 0; off >>= 1) {
        acc = merge(kd, acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x != 0) return;
    acc = red[0];
    for (int w = 1; w < kCombineThreads / 32; ++w) acc = merge(kd, acc, red[w]);
    if (kd == kSum) {
        out[k * G + g] = acc;
    } else if (kd == kCount) {
        // per-block counts are exact integers in float64 (< 2^53)
        reinterpret_cast<long long *>(out)[k * G + g] = llrint(acc);
    } else {
        reinterpret_cast<float *>(out + k * G)[g] = (float)acc;
    }
}

inline cudaError_t launch_combine(const double *part, int blocks,
                                  const Chains &ch, double *out,
                                  cudaStream_t stream) {
    combine_kernel<<<ch.n * ch.G, kCombineThreads, 0, stream>>>(
        part, blocks, ch, out);
    return cudaGetLastError();
}

// blocks of `kernel` one SM holds at `threads` and `smem` bytes of dynamic
// shared memory (after raising the kernel's dynamic-smem limit to it)
template <typename K>
inline int occupancy(K kernel, int threads, long long smem, int *per_sm) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, threads, static_cast<size_t>(smem)));
}

}  // namespace gp
