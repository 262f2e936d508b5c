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
// Codes past a dictionary row decode to 0, as on the TPU; rows outside
// [0, G) count nowhere.
//
// Bound on this card: bytes.  Per row the kernel reads the 4 B group
// index, 1 B of mask, 4 B per distinct plain column and 1 - 2 B per
// distinct code plate (Q1: 12 B), against a few f32 products and adds
// per slot.  Design:
//   - The wrapper hands the kernel distinct slots only (same kind, plain
//     column and factor list by identity share one chain; every count of
//     the shared mask is one chain), sums first.  Slots that share a plain
//     column or a code plate point at the same addresses, which the second
//     reader finds in L1.
//   - The partial chains live in shared memory in group_partials.cuh's
//     layout: one private column per thread, (s, c) pairs read and written
//     with 64-bit accesses.  T (128, 64 or 32, chosen by the wrapper from
//     the shared-memory budget) and the sums bucket KS (4, 8, 16) are
//     compile-time constants, so one row reads all of its words, updates
//     them in registers and writes them back: one shared-memory round
//     trip per row, no bank conflicts.  A row that is masked off or
//     outside [0, G) adds 0 (and a count of 0) to group 0 instead of
//     branching, as the plain version adds 0.
//   - The slot table and every pointer are one struct passed by value as
//     a __grid_constant__ parameter, laid out so that every field the row
//     loop reads has a compile-time index (slot k, factor h < kHoist): no
//     upload and no stream sync per call, and each read is a constant-bank
//     load with an immediate offset.
//   - Persistent grid: exactly (resident blocks per SM) x SMs blocks, each
//     walking a contiguous range of (batch, chunk) tiles of 4T rows.  A
//     block copies a batch's dictionary rows into shared memory, zero-
//     padded to 256 entries so a uint8 code reads its entry without a
//     check, only when its batch changes; there is no tail wave.
//     Dictionaries too wide for shared memory (rare) take one general
//     kernel per T that reads them through __ldg.
//   - Rows are read four at a time with 16-byte loads (int4 group index,
//     uchar4 mask, float4 plain, uchar4 / ushort4 codes) when cap % 4 == 0,
//     the bases are aligned and KS <= 8; a scalar loop takes the rest.
//     All loads of a step issue before the first decode, so a step waits
//     for one memory latency, not one per factor.
//   - Products are __fmul_rn, in the slot's factor order, so the compiler
//     cannot contract them into the Kahan subtraction.
//   - Each block folds its columns into part[slot, group, block]; one
//     combine kernel writes the final rows (float64 sums, int64 counts).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "group_partials.cuh"

constexpr int kMaxSlots = 16;
// factors of each sum held at a compile-time place in the spec, and whose
// code words the four-row step loads up front
constexpr int kHoist = 2;
// factors past the first kHoist of their sum, over all sums
constexpr int kMaxExtra = 16;
constexpr int kMaxDicts = 8;

// one code factor: its plate and the dictionary it decodes through
struct Factor {
    const void *codes;  // [B, cap] uint8 or uint16
    const float *dict;  // [B, dict_w]
    int code_bytes;     // 1 or 2
    int dict_w;
    int dict_off;       // offset of the row in shared memory
    int pad;
};

// at namespace scope: the extern "C" entry points below take it.  Every
// field the row loop reads sits at a compile-time index (slot k, factor
// h), so each read is a constant-bank load with an immediate offset.
struct CodeSpec {
    gp::Chains ch;  // sums [0, n_sums), then at most one count
    const int32_t *gidx;
    const uint8_t *mask;
    long long cap;
    int B;
    int n_dicts;
    const float *plain[kMaxSlots];  // per sum: its plain column or null
    int n_factors[kMaxSlots];
    int extra0[kMaxSlots];  // factors past kHoist: extra[extra0[k] ...]
    Factor factor[kMaxSlots][kHoist];
    Factor extra[kMaxExtra];
    const float *dicts[kMaxDicts];  // distinct dictionaries, for the reload
    int dict_w[kMaxDicts];
    int dict_off[kMaxDicts];
};

namespace {

// blocks of T threads per SM the register budget must allow: 896 threads
// (28 warps, 72 registers) up to 4 sums, the most the Q1 layout (30 KB
// of partials and dictionaries per block) fits; 768 (24 warps, 80
// registers) up to 8
template <int T, int KS>
constexpr int min_blocks() {
    return KS <= 4 ? 7 * 128 / T : KS <= 8 ? 6 * 128 / T : 1;
}

// DS: the dictionary rows sit in shared memory (else read through __ldg)
template <bool DS>
struct Decoder {
    const float *sdict;
    int b;

    // codes past the dictionary row decode to 0, as on the TPU; branch-free
    // (a clamped read, then a select), so lanes never diverge here.  A
    // uint8 code reads its shared-memory row directly: rows are staged
    // zero-padded to 256 entries.
    __device__ __forceinline__ float one(const Factor &fa, int code) const {
        if (DS && fa.code_bytes == 1) return sdict[fa.dict_off + code];
        const int at = min(code, fa.dict_w - 1);
        float d;
        if constexpr (DS) {
            d = sdict[fa.dict_off + at];
        } else {
            d = __ldg(fa.dict + (long long)b * fa.dict_w + at);
        }
        return code < fa.dict_w ? d : 0.0f;
    }
};

// row j of the step into the thread's own column of group g: every word
// read, updated in registers, written back.  Chains: the sums [0, n_sums), then at most one count
// (every count of the shared mask is the same chain).
template <int T, int KS, int R>
__device__ __forceinline__ void row_update(float *sm, const gp::Chains &ch,
                                           int W, int g, bool hit,
                                           const float (&v)[KS][R], int j) {
    // a row that is masked off or outside [0, G) adds 0 to group 0, so no
    // lane branches off (the plain version adds 0 the same way)
    const int gg = hit ? g : 0;
    float2 *pr = gp::pairs_of<T>(sm, W, gg);
    float *cnt = gp::singles_of<T>(sm, W, gg, ch.n_sums) + ch.n_sums * T;
    const bool count = ch.n > ch.n_sums;
    float s[KS], c[KS], n;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        if (k < ch.n_sums) {
            const float2 x = pr[k * T];
            s[k] = x.x;
            c[k] = x.y;
        }
    }
    if (count) n = *cnt;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        if (k < ch.n_sums) gp::kahan(s[k], c[k], hit ? v[k][j] : 0.0f);
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        if (k < ch.n_sums) pr[k * T] = make_float2(s[k], c[k]);
    }
    if (count) *cnt = __int_as_float(__float_as_int(n) + hit);
}

// the four codes of rows 4q .. 4q+3 of factor fa: the bytes of .x (uint8
// plates) or the halves of .x and .y (uint16 plates)
__device__ __forceinline__ uint2 code_word(const Factor &fa, long long base,
                                           long long q) {
    uint2 w;
    if (fa.code_bytes == 1) {
        w.x = reinterpret_cast<const unsigned *>(
            static_cast<const uint8_t *>(fa.codes) + base)[q];
    } else {
        w = reinterpret_cast<const uint2 *>(
            static_cast<const uint16_t *>(fa.codes) + base)[q];
    }
    return w;
}

// v[i] *= fa decoded from code i of w, in the slot's factor order
template <bool DS>
__device__ __forceinline__ void times_decoded(float (&v)[4], const Factor &fa,
                                              const Decoder<DS> &dec,
                                              uint2 w) {
    int c[4];
    if (fa.code_bytes == 1) {
        c[0] = w.x & 0xff; c[1] = (w.x >> 8) & 0xff;
        c[2] = (w.x >> 16) & 0xff; c[3] = w.x >> 24;
    } else {
        c[0] = w.x & 0xffff; c[1] = w.x >> 16;
        c[2] = w.y & 0xffff; c[3] = w.y >> 16;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(v[i], dec.one(fa, c[i]));
}

// four rows 4q .. 4q+3 of batch b with 16-byte loads.  Every load of the
// step (group index, mask, plain columns, the code words of the first
// kHoist factors of each sum) issues before the first use, so a step
// waits for one memory latency, not one per factor.
template <int T, int KS, bool DS>
__device__ __forceinline__ void quad(float *sm, const CodeSpec &sp, int W,
                                     const Decoder<DS> &dec, long long base,
                                     long long q) {
    const gp::Chains &ch = sp.ch;
    const int4 g4 = reinterpret_cast<const int4 *>(sp.gidx + base)[q];
    const uchar4 m4 = reinterpret_cast<const uchar4 *>(sp.mask + base)[q];
    float v[KS][4];
    uint2 cw[KS][kHoist];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        if (k >= ch.n_sums) continue;
        float4 x = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
        if (sp.plain[k]) {
            x = reinterpret_cast<const float4 *>(sp.plain[k] + base)[q];
        }
        v[k][0] = x.x; v[k][1] = x.y; v[k][2] = x.z; v[k][3] = x.w;
#pragma unroll
        for (int h = 0; h < kHoist; ++h) {
            if (h < sp.n_factors[k]) {
                cw[k][h] = code_word(sp.factor[k][h], base, q);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        if (k >= ch.n_sums) continue;
#pragma unroll
        for (int h = 0; h < kHoist; ++h) {
            if (h < sp.n_factors[k]) {
                times_decoded(v[k], sp.factor[k][h], dec, cw[k][h]);
            }
        }
        for (int e = 0; e < sp.n_factors[k] - kHoist; ++e) {
            const Factor &fa = sp.extra[sp.extra0[k] + e];
            times_decoded(v[k], fa, dec, code_word(fa, base, q));
        }
    }
    const unsigned G = ch.G;  // unsigned: a negative group is out too
    row_update<T, KS, 4>(sm, ch, W, g4.x, m4.x && unsigned(g4.x) < G, v, 0);
    row_update<T, KS, 4>(sm, ch, W, g4.y, m4.y && unsigned(g4.y) < G, v, 1);
    row_update<T, KS, 4>(sm, ch, W, g4.z, m4.z && unsigned(g4.z) < G, v, 2);
    row_update<T, KS, 4>(sm, ch, W, g4.w, m4.w && unsigned(g4.w) < G, v, 3);
}

template <bool DS>
__device__ __forceinline__ float decode_row(const Factor &fa,
                                            const Decoder<DS> &dec,
                                            long long at) {
    const int c = fa.code_bytes == 1
        ? static_cast<const uint8_t *>(fa.codes)[at]
        : static_cast<const uint16_t *>(fa.codes)[at];
    return dec.one(fa, c);
}

// one row r of batch b
template <int T, int KS, bool DS>
__device__ __forceinline__ void single(float *sm, const CodeSpec &sp, int W,
                                       const Decoder<DS> &dec, long long base,
                                       long long r) {
    const gp::Chains &ch = sp.ch;
    const int g = sp.gidx[base + r];
    if (!sp.mask[base + r] || g < 0 || g >= ch.G) return;
    float v[KS][1];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        if (k >= ch.n_sums) continue;
        float x = sp.plain[k] ? sp.plain[k][base + r] : 1.0f;
#pragma unroll
        for (int h = 0; h < kHoist; ++h) {
            if (h < sp.n_factors[k]) {
                x = __fmul_rn(x, decode_row(sp.factor[k][h], dec, base + r));
            }
        }
        for (int e = 0; e < sp.n_factors[k] - kHoist; ++e) {
            x = __fmul_rn(x, decode_row(sp.extra[sp.extra0[k] + e], dec,
                                        base + r));
        }
        v[k][0] = x;
    }
    row_update<T, KS, 1>(sm, ch, W, g, true, v, 0);
}

template <int T, int KS, bool DS>
__global__ void __launch_bounds__(T, (min_blocks<T, KS>()))
group_code_reduce_kernel(const __grid_constant__ CodeSpec sp, int vec,
                         double *__restrict__ part) {
    // shared memory: [partials: W * G * T floats][dictionary rows]
    extern __shared__ float sm[];
    const gp::Chains &ch = sp.ch;
    const int W = ch.n + ch.n_sums;
    float *sdict = sm + W * ch.G * T;
    gp::init_column<T>(sm, ch);

    // this block's contiguous range of (batch, chunk) tiles of 4T rows
    // (the wrapper keeps the tile count under 2^31)
    const long long cap = sp.cap;
    const int chunks = static_cast<int>((cap + 4 * T - 1) / (4 * T));
    const long long total = (long long)sp.B * chunks;
    const int lo = static_cast<int>(blockIdx.x * total / gridDim.x);
    const int hi = static_cast<int>((blockIdx.x + 1LL) * total / gridDim.x);
    const int quads = static_cast<int>(cap / 4);
    int b = lo / chunks;
    int c = lo - b * chunks;
    int loaded = -1;
    for (int tile = lo; tile < hi; ++tile) {
        if (DS && b != loaded) {
            __syncthreads();  // every thread is done with the old rows
            for (int di = 0; di < sp.n_dicts; ++di) {
                // zero-padded to 256 entries: a uint8 code reads its entry
                // without a bounds check
                const int w = sp.dict_w[di];
                const float *d = sp.dicts[di] + (long long)b * w;
                float *dst = sdict + sp.dict_off[di];
                for (int i = threadIdx.x; i < max(w, 256); i += T) {
                    dst[i] = i < w ? d[i] : 0.0f;
                }
            }
            __syncthreads();
            loaded = b;
        }
        const Decoder<DS> dec{sdict, b};
        const long long base = (long long)b * cap;
        bool wide = false;
        if constexpr (KS <= 8) {
            if (vec) {
                const int q = c * T + threadIdx.x;
                if (q < quads) quad<T, KS, DS>(sm, sp, W, dec, base, q);
                wide = true;
            }
        }
        if (!wide) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const long long r = (c * 4LL + j) * T + threadIdx.x;
                if (r < cap) single<T, KS, DS>(sm, sp, W, dec, base, r);
            }
        }
        if (++c == chunks) {
            c = 0;
            ++b;
        }
    }
    __syncthreads();
    gp::fold_block<T>(sm, ch, part);
}

template <int T, int KS, bool DS>
int launch(const CodeSpec &sp, int vec, double *part, int blocks,
           double *out, long long smem, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        group_code_reduce_kernel<T, KS, DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    group_code_reduce_kernel<T, KS, DS><<<blocks, T,
                                          static_cast<size_t>(smem),
                                          stream>>>(sp, vec, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(gp::launch_combine(part, blocks, sp.ch, out,
                                               stream));
}

// F(T, KS, DS) for every instantiated kernel; returns from the enclosing
// function.  Dictionaries too wide for shared memory are rare: one
// general kernel per T (KS 16, the scalar row loop) takes them.
#define GC_DISPATCH(F)                                                     \
    switch (dsmem ? threads * 100 + kb : -threads) {                       \
        case 12804: return F(128, 4, true);                                \
        case 12808: return F(128, 8, true);                                \
        case 12816: return F(128, 16, true);                               \
        case 6404: return F(64, 4, true);                                  \
        case 6408: return F(64, 8, true);                                  \
        case 6416: return F(64, 16, true);                                 \
        case 3204: return F(32, 4, true);                                  \
        case 3208: return F(32, 8, true);                                  \
        case 3216: return F(32, 16, true);                                 \
        case -128: return F(128, 16, false);                               \
        case -64: return F(64, 16, false);                                 \
        case -32: return F(32, 16, false);                                 \
        default: return static_cast<int>(cudaErrorInvalidValue);           \
    }

}  // namespace

// `spec` points at a host CodeSpec (sums first), copied into the kernel's
// parameters.  kb is the sums bucket (4, 8 or 16, >= n_sums; 16 without
// dsmem),
// threads 128, 64 or 32.  dsmem is nonzero when the dictionary rows are
// cached in shared memory (at spec->dict_off, after the partials); vec is
// nonzero when cap % 4 == 0 and every base is aligned for the four-row
// loads.  part holds n * G * blocks doubles of scratch; out receives the
// [n, G] final rows (float64 sums, int64 counts).  smem_bytes covers the
// partials and (with dsmem) the dictionaries.  Launches the kernel and the
// combine on `stream`; returns the first CUDA error (0 on success).
extern "C" int group_code_reduce(const CodeSpec *spec, int kb, int threads,
                                 int vec, int dsmem, void *part, int blocks,
                                 void *out, long long smem_bytes,
                                 void *stream) {
    double *p = static_cast<double *>(part);
    double *o = static_cast<double *>(out);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define GC_LAUNCH(T, KS, DS) \
    launch<T, KS, DS>(*spec, vec, p, blocks, o, smem_bytes, s)
    GC_DISPATCH(GC_LAUNCH)
#undef GC_LAUNCH
}

// resident blocks per SM of the (threads, kb, dsmem) kernel at smem_bytes
// of dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
extern "C" int group_code_reduce_occupancy(int kb, int threads, int dsmem,
                                           long long smem_bytes,
                                           int *per_sm) {
#define GC_OCC(T, KS, DS) \
    gp::occupancy(group_code_reduce_kernel<T, KS, DS>, T, smem_bytes, per_sm)
    GC_DISPATCH(GC_OCC)
#undef GC_OCC
}
