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
// does a handful of f32 adds per slot; HBM bandwidth (3.35 TB/s) is the
// limit, not arithmetic.  Design:
//   - The partial chains live in shared memory, one private column per
//     thread: word w of group g of thread t sits at [(w * G + g) * T + t].
//     A thread only ever touches its own column, so there are no races
//     and no atomics, and consecutive threads hit consecutive banks for
//     any mix of groups, so the scattered group index causes no bank
//     conflicts.  The smem size is words * G * T * 4 bytes; the Python
//     side (op_smem_bytes) stops fusing slots before it passes 227 KB.
//   - Rows are read in a grid-stride loop, coalesced, four rows per
//     thread and step with 16-byte loads, so each op's loads for the four
//     rows are in flight together (a scalar loop takes the ragged tail and
//     unaligned inputs).  Inputs shared by several slots are passed once
//     (the wrapper deduplicates them by identity) and re-reads within one
//     step hit L1.
//   - At the end each block folds its threads' chains per (slot, group):
//     one warp per (slot, group) pair, sums as sum(s) - sum(c) in float64,
//     counts as integers, min/max in float.  Each block writes one float64
//     per (slot, group) to `part` [blocks, n_ops, G]; the wrapper combines
//     the blocks outside the kernel in float64 / int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math (it would let the compiler
// cancel the Kahan compensation).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#define GR_MAX_OPS 32

// kinds: 0 sum, 1 count, 2 min, 3 max
struct GroupSpec {
    int n_ops;
    int kind[GR_MAX_OPS];
    int word[GR_MAX_OPS];  // first smem word of the op (sum uses 2)
    const float *values[GR_MAX_OPS];  // null for count
    const uint8_t *masks[GR_MAX_OPS];
};

namespace {

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

// one row of one op into the thread's own chain of group g; a row whose
// mask is off, or whose group lies outside [0, G), changes nothing
__device__ __forceinline__ void update(float *sm, int *smi, int kind, int w,
                                       int G, int T, int t, int g,
                                       uint8_t m, float v) {
    if (!m || g < 0 || g >= G) return;
    const int at = (w * G + g) * T + t;
    if (kind == 0) {
        const int atc = ((w + 1) * G + g) * T + t;
        const float s = sm[at];
        const float y = v - sm[atc];
        const float tt = s + y;
        sm[atc] = (tt - s) - y;
        sm[at] = tt;
    } else if (kind == 1) {
        smi[at] += 1;
    } else if (kind == 2) {
        sm[at] = nan_min(v, sm[at]);
    } else {
        sm[at] = nan_max(v, sm[at]);
    }
}

__global__ void group_reduce_kernel(const int32_t *__restrict__ gidx,
                                    long long n, const GroupSpec spec,
                                    int G, int vec,
                                    double *__restrict__ part) {
    extern __shared__ float sm[];
    const int T = blockDim.x;
    const int t = threadIdx.x;
    int *smi = reinterpret_cast<int *>(sm);

    for (int k = 0; k < spec.n_ops; ++k) {
        const int w = spec.word[k];
        const int kind = spec.kind[k];
        for (int g = 0; g < G; ++g) {
            if (kind == 0) {
                sm[(w * G + g) * T + t] = 0.0f;
                sm[((w + 1) * G + g) * T + t] = 0.0f;
            } else if (kind == 1) {
                smi[(w * G + g) * T + t] = 0;
            } else if (kind == 2) {
                sm[(w * G + g) * T + t] = CUDART_INF_F;
            } else {
                sm[(w * G + g) * T + t] = -CUDART_INF_F;
            }
        }
    }
    // each thread owns its column: no barrier needed before the loop

    const long long stride = (long long)gridDim.x * T;
    const long long first = blockIdx.x * (long long)T + t;
    // four rows per step with 16-byte loads (int4 of group index, float4
    // of values, uchar4 of mask): each op's loads for the four rows are
    // in flight together instead of one dependent load per row
    const long long n4 = vec ? n / 4 : 0;
    for (long long q = first; q < n4; q += stride) {
        const int4 g4 = reinterpret_cast<const int4 *>(gidx)[q];
        for (int k = 0; k < spec.n_ops; ++k) {
            const uchar4 m4 = reinterpret_cast<const uchar4 *>(spec.masks[k])[q];
            float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (spec.kind[k] != 1) {
                v4 = reinterpret_cast<const float4 *>(spec.values[k])[q];
            }
            const int w = spec.word[k];
            const int kind = spec.kind[k];
            update(sm, smi, kind, w, G, T, t, g4.x, m4.x, v4.x);
            update(sm, smi, kind, w, G, T, t, g4.y, m4.y, v4.y);
            update(sm, smi, kind, w, G, T, t, g4.z, m4.z, v4.z);
            update(sm, smi, kind, w, G, T, t, g4.w, m4.w, v4.w);
        }
    }
    for (long long r = n4 * 4 + first; r < n; r += stride) {
        const int g = gidx[r];
        for (int k = 0; k < spec.n_ops; ++k) {
            const int kind = spec.kind[k];
            update(sm, smi, kind, spec.word[k], G, T, t, g, spec.masks[k][r],
                   kind == 1 ? 0.0f : spec.values[k][r]);
        }
    }
    __syncthreads();

    // fold the block's T chains: one warp per (op, group) pair
    const int warp = t >> 5;
    const int lane = t & 31;
    const int nwarps = T >> 5;
    const int pairs = spec.n_ops * G;
    for (int p = warp; p < pairs; p += nwarps) {
        const int k = p / G;
        const int g = p - k * G;
        const int w = spec.word[k];
        const int kind = spec.kind[k];
        double acc;
        if (kind == 0 || kind == 1) {
            acc = 0.0;
        } else {
            acc = (kind == 2) ? CUDART_INF : -CUDART_INF;
        }
        for (int j = lane; j < T; j += 32) {
            const int at = (w * G + g) * T + j;
            if (kind == 0) {
                acc += (double)sm[at] - (double)sm[((w + 1) * G + g) * T + j];
            } else if (kind == 1) {
                acc += (double)smi[at];
            } else if (kind == 2) {
                acc = nan_min((double)sm[at], acc);
            } else {
                acc = nan_max((double)sm[at], acc);
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const double o = __shfl_down_sync(0xffffffffu, acc, off);
            if (kind == 0 || kind == 1) {
                acc += o;
            } else if (kind == 2) {
                acc = nan_min(o, acc);
            } else {
                acc = nan_max(o, acc);
            }
        }
        if (lane == 0) {
            part[((long long)blockIdx.x * spec.n_ops + k) * G + g] = acc;
        }
    }
}

}  // namespace

// `spec` points at a host GroupSpec, copied into the kernel's parameters.
// `vec` is nonzero when gidx and every value input are 16-byte aligned and
// every mask 4-byte aligned (the four-row loads need it).  part holds
// blocks * spec->n_ops * G doubles.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int group_reduce_f32(const void *gidx, long long n,
                                const GroupSpec *spec, int G, int vec,
                                void *part, int blocks, int threads,
                                long long smem_bytes, void *stream) {
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            group_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    group_reduce_kernel<<<blocks, threads, static_cast<size_t>(smem_bytes),
                          reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t *>(gidx), n, *spec, G, vec,
        static_cast<double *>(part));
    return static_cast<int>(cudaGetLastError());
}
