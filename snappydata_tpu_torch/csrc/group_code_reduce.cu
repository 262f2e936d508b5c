// Fused grouped reduction over code plates (the TPC-H Q1 shape over
// encoded batches), for Hopper (sm_90a).
//
// Replaces the TPU kernel snappydata_tpu/ops/pallas_group.py
// grouped_code_reduce (kernel from _make_code_kernel, launched by
// _grouped_code_call).  Over [B, cap] plates with one shared row mask,
// each slot is either a COUNT or the compensated SUM of
//
//     plain * dict_1[b, codes_1] * dict_2[b, codes_2] * ...
//
// (the plain f32 column optional, any number of code factors, each
// decoded from its per-batch dictionary row — Q1's (1 - disc) and
// (1 + tax) ride host-transformed dictionaries), per group g < G <= 64.
// Codes past a dictionary row decode to 0, as on the TPU.
//
// Bound on this card: bytes.  Per row the kernel reads the 4 B group
// index, 1 B of mask, 4 B per distinct plain column and 1 - 2 B per
// distinct code plate (Q1: 12 B), against a few f32 products and adds
// per slot.  Design, from group_reduce.cu:
//   - The partial chains live in shared memory, one private column per
//     thread: word w of group g of thread t at [(w * G + g) * T + t].  No
//     races, no atomics, no bank conflicts whatever the group mix.  Sums
//     take two words (Kahan s, c), counts one (an exact int).  T is chosen
//     by the wrapper from the shared-memory budget, down to one warp.
//   - Grid (blocks_per_batch, B): blockIdx.y is the batch, so each block
//     copies its batch's dictionary rows into shared memory once (when
//     they fit; otherwise they are read through __ldg), beside the slot
//     spec (a small int table in device memory, also copied in).
//   - Inputs are deduplicated by identity in the wrapper: every distinct
//     plain column and code plate is one pointer, read once per row from
//     HBM; slots that share it re-read the same 16-byte line from L1.
//   - Rows are read four at a time with 16-byte loads (int4 group index,
//     uchar4 mask, float4 plain, uchar4 / ushort4 codes) when cap % 4 == 0
//     and the bases are aligned; a scalar loop takes the rest.
//   - Products are __fmul_rn, in the slot's factor order, so the compiler
//     cannot contract them into the Kahan subtraction.
//   - At the end each block folds its threads' chains, one warp per
//     (slot, group): sums as sum(s) - sum(c) in float64, counts as
//     integers, one float64 per (slot, group) to part[block, slot, group];
//     the wrapper combines the blocks in float64 / int64.
//
// Spec (int32, device memory), written by ops/group_reduce.py:
//   [0] n_slots  [1] n_plains  [2] n_codes  [3] n_dicts  [4] n_factors
//   [5] partial words per group and thread (2 per sum, 1 per count);
//   then per slot k at 6 + 5k: kind (0 sum, 1 count), first word, plain
//   index (-1: none), factor count, first factor;
//   then per factor: code index, dict index;
//   then per code plate its width in bytes (1 or 2);
//   then per dictionary its row width, then its offset in shared memory.
// ptrs (int64, device memory): plains, then code plates, then dicts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Layout {
    const int *sp;
    int n_slots, n_plains, n_codes, n_dicts;
    int fac0, cb0, dw0, doff0;
};

__device__ __forceinline__ Layout layout(const int *sp) {
    Layout L;
    L.sp = sp;
    L.n_slots = sp[0];
    L.n_plains = sp[1];
    L.n_codes = sp[2];
    L.n_dicts = sp[3];
    L.fac0 = 6 + 5 * L.n_slots;
    L.cb0 = L.fac0 + 2 * sp[4];
    L.dw0 = L.cb0 + L.n_codes;
    L.doff0 = L.dw0 + L.n_dicts;
    return L;
}

__device__ __forceinline__ void kahan(float *sm, int at, int atc, float v) {
    const float s = sm[at];
    const float y = v - sm[atc];
    const float t = s + y;
    sm[atc] = (t - s) - y;
    sm[at] = t;
}

// the four decoded values of factor f for rows 4q .. 4q+3 (vec) or row r
struct Dec {
    Layout L;
    const long long *ptrs;
    const float *sdict;
    bool dsmem;
    long long base;  // b * cap
    int b;

    __device__ __forceinline__ float one(int di, int code) const {
        const int w = L.sp[L.dw0 + di];
        if (code >= w) return 0.0f;
        if (dsmem) return sdict[L.sp[L.doff0 + di] + code];
        const float *d = reinterpret_cast<const float *>(
            ptrs[L.n_plains + L.n_codes + di]);
        return __ldg(d + (long long)b * w + code);
    }

    __device__ __forceinline__ float4 four(int f, long long q) const {
        const int ci = L.sp[L.fac0 + 2 * f];
        const int di = L.sp[L.fac0 + 2 * f + 1];
        const void *p = reinterpret_cast<const void *>(ptrs[L.n_plains + ci]);
        int c0, c1, c2, c3;
        if (L.sp[L.cb0 + ci] == 1) {
            const uchar4 c = reinterpret_cast<const uchar4 *>(
                static_cast<const uint8_t *>(p) + base)[q];
            c0 = c.x; c1 = c.y; c2 = c.z; c3 = c.w;
        } else {
            const ushort4 c = reinterpret_cast<const ushort4 *>(
                static_cast<const uint16_t *>(p) + base)[q];
            c0 = c.x; c1 = c.y; c2 = c.z; c3 = c.w;
        }
        return make_float4(one(di, c0), one(di, c1), one(di, c2),
                           one(di, c3));
    }

    __device__ __forceinline__ float row(int f, long long r) const {
        const int ci = L.sp[L.fac0 + 2 * f];
        const int di = L.sp[L.fac0 + 2 * f + 1];
        const void *p = reinterpret_cast<const void *>(ptrs[L.n_plains + ci]);
        const int c = L.sp[L.cb0 + ci] == 1
                          ? static_cast<const uint8_t *>(p)[base + r]
                          : static_cast<const uint16_t *>(p)[base + r];
        return one(di, c);
    }
};

__device__ __forceinline__ bool hit(uint8_t m, int g, int G) {
    return m && g >= 0 && g < G;
}

__global__ void group_code_reduce_kernel(
        const int32_t *__restrict__ gidx, const uint8_t *__restrict__ mask,
        long long cap, const int *__restrict__ spec, int spec_len,
        const long long *__restrict__ ptrs, int G, int vec, int dsmem,
        double *__restrict__ part) {
    // shared memory: [spec][partials: words * G * T][dictionary rows]
    extern __shared__ int ssp[];
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int b = blockIdx.y;
    for (int i = t; i < spec_len; i += T) ssp[i] = spec[i];
    __syncthreads();
    const Layout L = layout(ssp);
    float *sm = reinterpret_cast<float *>(ssp + spec_len);
    int *smi = ssp + spec_len;
    float *sdict = sm + ssp[5] * G * T;
    if (dsmem) {
        for (int di = 0; di < L.n_dicts; ++di) {
            const int w = ssp[L.dw0 + di];
            const float *d = reinterpret_cast<const float *>(
                ptrs[L.n_plains + L.n_codes + di]) + (long long)b * w;
            float *dst = sdict + ssp[L.doff0 + di];
            for (int i = t; i < w; i += T) dst[i] = d[i];
        }
    }
    for (int k = 0; k < L.n_slots; ++k) {
        const int kind = ssp[6 + 5 * k];
        const int w = ssp[6 + 5 * k + 1];
        for (int g = 0; g < G; ++g) {
            if (kind == 0) {
                sm[(w * G + g) * T + t] = 0.0f;
                sm[((w + 1) * G + g) * T + t] = 0.0f;
            } else {
                smi[(w * G + g) * T + t] = 0;
            }
        }
    }
    __syncthreads();

    const long long base = (long long)b * cap;
    const int32_t *gb = gidx + base;
    const uint8_t *mb = mask + base;
    const Dec dec{L, ptrs, sdict, dsmem != 0, base, b};
    const long long first = blockIdx.x * (long long)T + t;
    const long long stride = (long long)gridDim.x * T;
    long long done = 0;
    if (vec) {
        const long long n4 = cap / 4;
        for (long long q = first; q < n4; q += stride) {
            const int4 g4 = reinterpret_cast<const int4 *>(gb)[q];
            const uchar4 m4 = reinterpret_cast<const uchar4 *>(mb)[q];
            const bool h0 = hit(m4.x, g4.x, G), h1 = hit(m4.y, g4.y, G),
                       h2 = hit(m4.z, g4.z, G), h3 = hit(m4.w, g4.w, G);
            for (int k = 0; k < L.n_slots; ++k) {
                const int *s = ssp + 6 + 5 * k;
                const int w = s[1];
                if (s[0] == 1) {
                    if (h0) smi[(w * G + g4.x) * T + t] += 1;
                    if (h1) smi[(w * G + g4.y) * T + t] += 1;
                    if (h2) smi[(w * G + g4.z) * T + t] += 1;
                    if (h3) smi[(w * G + g4.w) * T + t] += 1;
                    continue;
                }
                float4 v = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
                if (s[2] >= 0) {
                    const float *pl = reinterpret_cast<const float *>(
                        ptrs[s[2]]) + base;
                    v = reinterpret_cast<const float4 *>(pl)[q];
                }
                for (int f = s[4]; f < s[4] + s[3]; ++f) {
                    const float4 d = dec.four(f, q);
                    v.x = __fmul_rn(v.x, d.x);
                    v.y = __fmul_rn(v.y, d.y);
                    v.z = __fmul_rn(v.z, d.z);
                    v.w = __fmul_rn(v.w, d.w);
                }
                if (h0) kahan(sm, (w * G + g4.x) * T + t,
                              ((w + 1) * G + g4.x) * T + t, v.x);
                if (h1) kahan(sm, (w * G + g4.y) * T + t,
                              ((w + 1) * G + g4.y) * T + t, v.y);
                if (h2) kahan(sm, (w * G + g4.z) * T + t,
                              ((w + 1) * G + g4.z) * T + t, v.z);
                if (h3) kahan(sm, (w * G + g4.w) * T + t,
                              ((w + 1) * G + g4.w) * T + t, v.w);
            }
        }
        done = n4 * 4;
    }
    for (long long r = done + first; r < cap; r += stride) {
        const int g = gb[r];
        if (!hit(mb[r], g, G)) continue;
        for (int k = 0; k < L.n_slots; ++k) {
            const int *s = ssp + 6 + 5 * k;
            const int w = s[1];
            if (s[0] == 1) {
                smi[(w * G + g) * T + t] += 1;
                continue;
            }
            float v = 1.0f;
            if (s[2] >= 0) {
                v = reinterpret_cast<const float *>(ptrs[s[2]])[base + r];
            }
            for (int f = s[4]; f < s[4] + s[3]; ++f) {
                v = __fmul_rn(v, dec.row(f, r));
            }
            kahan(sm, (w * G + g) * T + t, ((w + 1) * G + g) * T + t, v);
        }
    }
    __syncthreads();

    // fold the block's T chains: one warp per (slot, group) pair
    const int warp = t >> 5;
    const int lane = t & 31;
    const int nwarps = T >> 5;
    const int pairs = L.n_slots * G;
    const long long blk = (long long)b * gridDim.x + blockIdx.x;
    for (int p = warp; p < pairs; p += nwarps) {
        const int k = p / G;
        const int g = p - k * G;
        const int kind = ssp[6 + 5 * k];
        const int w = ssp[6 + 5 * k + 1];
        double acc = 0.0;
        for (int j = lane; j < T; j += 32) {
            const int at = (w * G + g) * T + j;
            if (kind == 0) {
                acc += (double)sm[at] - (double)sm[((w + 1) * G + g) * T + j];
            } else {
                acc += (double)smi[at];
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) part[(blk * L.n_slots + k) * G + g] = acc;
    }
}

}  // namespace

// gidx [B, cap] int32, mask [B, cap] bool; spec / ptrs as described above,
// in device memory.  dsmem is nonzero when the dictionary rows are cached
// in shared memory (their offsets are in the spec).  vec is nonzero when
// cap % 4 == 0 and every base is aligned for the four-row loads.  The grid
// is (blocks_x, B) blocks of `threads`; smem_bytes covers the partials, the
// spec and (with dsmem) the dictionaries; part holds
// B * blocks_x * n_slots * G doubles.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int group_code_reduce(const void *gidx, const void *mask, int B,
                                 long long cap, const void *spec,
                                 int spec_len, const void *ptrs, int G,
                                 int vec, int dsmem, void *part,
                                 int blocks_x, int threads,
                                 long long smem_bytes, void *stream) {
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            group_code_reduce_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    group_code_reduce_kernel<<<dim3(blocks_x, B), threads,
                               static_cast<size_t>(smem_bytes),
                               reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t *>(gidx),
        static_cast<const uint8_t *>(mask), cap,
        static_cast<const int *>(spec), spec_len,
        static_cast<const long long *>(ptrs), G, vec, dsmem,
        static_cast<double *>(part));
    return static_cast<int>(cudaGetLastError());
}
