// Masked compensated (Kahan) sum of float32 values, for Hopper (sm_90a).
//
// Replaces the TPU kernel snappydata_tpu/ops/pallas_reduce.py
// masked_kahan_sum (_kahan_kernel): one pass over the f32 values, each
// chain keeping its own Kahan compensation, the partial (sum,
// compensation) pairs combined outside the kernel in float64 as
// sum(s) - sum(c).
//
// Bound on this card: bytes.  Per row the kernel reads 4 B of value and
// 1 B of mask and does four f32 adds, far below the card's 67 TFLOP/s
// f32 rate, so the 3.35 TB/s of HBM bandwidth is the limit.  The design
// keeps the loads wide and coalesced: a grid-stride loop where each
// thread reads a float4 of values and a uchar4 of mask per step (a
// scalar loop covers the ragged tail and unaligned inputs), and every
// thread runs its own f32 Kahan chain in registers.  In place of the TPU's
// per-lane chains that ran down the rows of a [rows, 128] layout, the
// chains here are per thread.  Nothing is reduced across threads inside
// the kernel: each thread writes its (s, c) pair to the partial arrays,
// a few hundred KB in all, and the wrapper combines them in float64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math: it lets the compiler
// simplify (t - s) - y to zero and undo the compensation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void kahan_add(float v, float &s, float &c) {
    // c holds the excess already folded into s, so the chain total is s - c
    float y = v - c;
    float t = s + y;
    c = (t - s) - y;
    s = t;
}

__global__ void kahan_sum_kernel(const float *__restrict__ values,
                                 const uint8_t *__restrict__ mask,
                                 long long n,
                                 float *__restrict__ part_s,
                                 float *__restrict__ part_c) {
    const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    float s = 0.0f;
    float c = 0.0f;
    const bool vec = ((reinterpret_cast<uintptr_t>(values) & 15) == 0) &&
                     ((reinterpret_cast<uintptr_t>(mask) & 3) == 0);
    long long done = 0;
    if (vec) {
        const long long n4 = n / 4;
        const float4 *v4 = reinterpret_cast<const float4 *>(values);
        const uchar4 *m4 = reinterpret_cast<const uchar4 *>(mask);
        for (long long i = tid; i < n4; i += nthreads) {
            const float4 v = v4[i];
            const uchar4 m = m4[i];
            kahan_add(m.x ? v.x : 0.0f, s, c);
            kahan_add(m.y ? v.y : 0.0f, s, c);
            kahan_add(m.z ? v.z : 0.0f, s, c);
            kahan_add(m.w ? v.w : 0.0f, s, c);
        }
        done = n4 * 4;
    }
    for (long long i = done + tid; i < n; i += nthreads) {
        kahan_add(mask[i] ? values[i] : 0.0f, s, c);
    }
    part_s[tid] = s;
    part_c[tid] = c;
}

}  // namespace

// Launches on `stream`; part_s/part_c hold blocks * threads floats each.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int kahan_sum_f32(const void *values, const void *mask,
                             long long n, void *part_s, void *part_c,
                             int blocks, int threads, void *stream) {
    kahan_sum_kernel<<<blocks, threads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float *>(values),
        static_cast<const uint8_t *>(mask), n,
        static_cast<float *>(part_s), static_cast<float *>(part_c));
    return static_cast<int>(cudaGetLastError());
}
