// Masked compensated (Kahan) sum of float32 values, for Hopper (sm_90a).
//
// Replaces the TPU kernel snappydata_tpu/ops/pallas_reduce.py
// masked_kahan_sum (_kahan_kernel): one pass over the f32 values, each
// chain keeping its own Kahan compensation, the chains combined in
// float64.
//
// Bound on this card: bytes.  Per row the kernel reads 4 B of value and
// 1 B of mask and does four f32 adds, far below the card's 67 TFLOP/s
// f32 rate, so the 3.35 TB/s of HBM bandwidth is the limit.  What the
// design does about it:
//
// - One launch, one output.  Each thread runs its f32 Kahan chain in
//   registers and turns its pair into a float64 s - c; a warp sums those
//   with shuffles, the block sums its warps in shared memory in warp
//   order and writes one f64 partial.  After a __threadfence() each
//   block takes a ticket from a device counter; the last block to arrive
//   sums the partials in a fixed order (thread t takes blocks t, t + T,
//   ..., then the same warp and block tree), writes out[0] and puts the
//   counter back to 0 for the next launch.  Every add happens in the
//   same order on every run, so repeated calls are bit-identical.
// - Bytes in flight.  The main loop issues UNROLL independent 16-byte
//   value loads and their 4-byte mask words (streaming cache hint: every
//   byte is read once) before the dependent adds.  At a tile of 4 - 8M
//   rows the grid is 256 - 512 blocks, 2 - 4 per SM, so latency is hidden
//   by each thread's loads in flight rather than by resident warps; on
//   an H100 a single-load loop took more device time there, and the same
//   at 100M rows.
// - Unaligned views.  A scalar head of 0 - 3 rows is peeled so that an
//   input whose value and mask offsets agree modulo 4 rows still takes
//   the vector loop; the wrapper computes the head.  Other inputs, and
//   the ragged tail, run a scalar grid-stride loop.
// - The grid is sized by the wrapper to the work and to the resident
//   blocks per SM (kahan_occupancy), so each thread streams enough rows
//   that the combine and the launch tail stay small beside the stream.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math: it lets the compiler
// simplify (t - s) - y to zero and undo the compensation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;

__device__ __forceinline__ void kahan_add(float v, float &s, float &c) {
    // c holds the excess already folded into s, so the chain total is s - c
    float y = v - c;
    float t = s + y;
    c = (t - s) - y;
    s = t;
}

__device__ __forceinline__ void kahan_add4(float4 v, unsigned int m,
                                           float &s, float &c) {
    kahan_add((m & 0xffu) ? v.x : 0.0f, s, c);
    kahan_add((m & 0xff00u) ? v.y : 0.0f, s, c);
    kahan_add((m & 0xff0000u) ? v.z : 0.0f, s, c);
    kahan_add((m & 0xff000000u) ? v.w : 0.0f, s, c);
}

// Sum of one double per thread over the block, in a fixed order; the
// result is valid in thread 0.  `warp_part` is WARPS doubles of shared
// memory, free on entry.
__device__ __forceinline__ double block_sum(double d, double *warp_part) {
    for (int off = 16; off > 0; off >>= 1) {
        d += __shfl_down_sync(0xffffffffu, d, off);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        warp_part[warp] = d;
    }
    __syncthreads();
    double total = 0.0;
    if (threadIdx.x == 0) {
        for (int w = 0; w < WARPS; ++w) {
            total += warp_part[w];
        }
    }
    return total;
}

// Rows [0, head) and [head + 4 * n4, n) are read one by one; rows
// [head, head + 4 * n4) as float4 values and 4-byte mask words, whose
// bases the wrapper guarantees are 16- and 4-byte aligned.
__global__ void __launch_bounds__(THREADS)
kahan_sum_kernel(const float *__restrict__ values,
                 const uint8_t *__restrict__ mask, long long n,
                 long long head, long long n4,
                 double *__restrict__ block_part,
                 unsigned int *__restrict__ counter,
                 double *__restrict__ out) {
    __shared__ double warp_part[WARPS];
    __shared__ bool last;
    const long long tid = blockIdx.x * (long long)THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * THREADS;
    float s = 0.0f;
    float c = 0.0f;

    if (tid < head) {
        kahan_add(mask[tid] ? values[tid] : 0.0f, s, c);
    }
    const float4 *v4 = reinterpret_cast<const float4 *>(values + head);
    const unsigned int *m4 =
        reinterpret_cast<const unsigned int *>(mask + head);
    long long i = tid;
    for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
        float4 v[UNROLL];
        unsigned int m[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            v[u] = __ldcs(v4 + i + u * stride);
            m[u] = __ldcs(m4 + i + u * stride);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            kahan_add4(v[u], m[u], s, c);
        }
    }
    for (; i < n4; i += stride) {
        kahan_add4(__ldcs(v4 + i), __ldcs(m4 + i), s, c);
    }
    for (long long r = head + 4 * n4 + tid; r < n; r += stride) {
        kahan_add(mask[r] ? values[r] : 0.0f, s, c);
    }

    const double mine = block_sum((double)s - (double)c, warp_part);
    if (threadIdx.x == 0) {
        block_part[blockIdx.x] = mine;
        __threadfence();
        last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) {
        return;
    }
    // the last block: every other block's partial is visible in L2
    double d = 0.0;
    for (unsigned int b = threadIdx.x; b < gridDim.x; b += THREADS) {
        d += __ldcg(block_part + b);
    }
    const double total = block_sum(d, warp_part);
    if (threadIdx.x == 0) {
        out[0] = total;
        *counter = 0u;
    }
}

}  // namespace

// Launches on `stream`.  block_part holds `blocks` doubles; counter is one
// unsigned int that is 0 on entry and 0 again when the kernel ends; out
// is one double.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue when `threads` is not the kernel's
// block size.
extern "C" int kahan_sum_f32(const void *values, const void *mask,
                             long long n, long long head, long long n4,
                             void *block_part, void *counter, void *out,
                             int blocks, int threads, void *stream) {
    if (threads != THREADS) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    kahan_sum_kernel<<<blocks, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float *>(values),
        static_cast<const uint8_t *>(mask), n, head, n4,
        static_cast<double *>(block_part),
        static_cast<unsigned int *>(counter), static_cast<double *>(out));
    return static_cast<int>(cudaGetLastError());
}

// Resident blocks of `threads` threads per SM (dynamic shared memory
// `smem` bytes) into *per_sm; returns the CUDA error code.
extern "C" int kahan_occupancy(int threads, long long smem, int *per_sm) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kahan_sum_kernel, threads, static_cast<size_t>(smem)));
}
