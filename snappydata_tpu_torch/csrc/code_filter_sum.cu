// Fused code-domain filter + compensated sum (the TPC-H Q6 shape over
// encoded batches), for Hopper (sm_90a).
//
// Replaces the TPU kernel snappydata_tpu/ops/pallas_reduce.py
// fused_code_filter_sum (_fused_q6_kernel, launched by _fused_q6_call):
//
//     sum(price * decode(disc)), count(*)
//     WHERE valid AND qty_code < qhi[b]
//       AND dlo[b] <= disc_code <= dhi[b]
//       AND slo <= ship < shi
//
// over [B, cap] plates: the quantity and discount columns stay uint8 /
// uint16 codes compared against per-batch int32 code thresholds (the
// host translated the literals through each batch's sorted dictionary),
// the shipdate range is int32, and the discount decodes in the kernel
// from the batch's dictionary row.  Codes past the dictionary decode to 0,
// as the TPU kernel's select chain leaves them.
//
// Bound on this card: bytes.  Per row the kernel reads 1 + 1 B of codes
// (uint8), 4 B of shipdate, 4 B of price and 1 B of validity — 11 B — and
// does a few integer compares, one f32 product and four f32 adds, far
// below the card's 67 TFLOP/s; HBM (3.35 TB/s) sets the pace.  Design:
//   - Grid (blocks_per_batch, B): blockIdx.y is the batch, so a block
//     reads its batch's three thresholds and dictionary row once.  The
//     dictionary goes to shared memory when it has at most CFS_SMEM_DICT
//     entries (Q6's discount dictionary is 11 entries padded to 16);
//     a wider one (uint16 codes) is read through __ldg.
//   - Each thread runs a grid-stride loop inside its batch, four rows per
//     step with vector loads (uchar4 / ushort4 codes, int4 shipdate,
//     float4 price, uchar4 validity) when cap % 4 == 0 and the inputs are
//     aligned; a scalar loop takes the rest.  Every thread keeps one f32
//     Kahan chain and an exact integer count in registers.
//   - Nothing is reduced across threads: each thread writes its (s, c,
//     count) partials and the wrapper combines them as sum(s) - sum(c) in
//     float64 and sum(count) in int64 — the sign convention of the TPU
//     kernel's combine and of kahan_reduce.cu.  Counts are integers, not
//     the f32 lanes the TPU kernel used.
//   - Products are __fmul_rn so the compiler cannot contract the product
//     into the Kahan subtraction (the plain version rounds it separately).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.  Never --use_fast_math (it could fold the Kahan
// compensation away).

#include <cstdint>
#include <cuda_runtime.h>

#define CFS_SMEM_DICT 1024

namespace {

__device__ __forceinline__ void kahan_add(float v, float &s, float &c) {
    // c holds the excess already folded into s, so the chain total is s - c
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
}

struct Batch {
    int qhi, dlo, dhi, slo, shi, D;
    bool smem;
    const float *drow;   // the batch's dictionary row in device memory
    const float *sdict;  // the same row in shared memory (when smem)
};

__device__ __forceinline__ float decode(const Batch &bt, int code) {
    if (code >= bt.D) return 0.0f;
    return bt.smem ? bt.sdict[code] : __ldg(bt.drow + code);
}

__device__ __forceinline__ void row(const Batch &bt, int q, int d, int sh,
                                    float p, uint8_t ok_valid, float &s,
                                    float &c, long long &n) {
    const bool ok = ok_valid && q < bt.qhi && d >= bt.dlo && d <= bt.dhi &&
                    sh >= bt.slo && sh < bt.shi;
    kahan_add(ok ? __fmul_rn(p, decode(bt, d)) : 0.0f, s, c);
    n += ok ? 1 : 0;
}

template <typename C> struct Vec4;
template <> struct Vec4<uint8_t> { typedef uchar4 T; };
template <> struct Vec4<uint16_t> { typedef ushort4 T; };

template <typename CQ, typename CD>
__global__ void code_filter_sum_kernel(
        const CQ *__restrict__ qty, const CD *__restrict__ disc,
        const int32_t *__restrict__ ship, const float *__restrict__ price,
        const uint8_t *__restrict__ valid, const float *__restrict__ dicts,
        int D, const int32_t *__restrict__ qhi,
        const int32_t *__restrict__ dlo, const int32_t *__restrict__ dhi,
        int slo, int shi, long long cap, int vec,
        float *__restrict__ part_s, float *__restrict__ part_c,
        long long *__restrict__ part_n) {
    __shared__ float sdict[CFS_SMEM_DICT];
    const int b = blockIdx.y;
    const int T = blockDim.x;
    const int t = threadIdx.x;
    Batch bt;
    bt.qhi = qhi[b];
    bt.dlo = dlo[b];
    bt.dhi = dhi[b];
    bt.slo = slo;
    bt.shi = shi;
    bt.D = D;
    bt.drow = dicts + (long long)b * D;
    bt.smem = D <= CFS_SMEM_DICT;
    bt.sdict = sdict;
    if (bt.smem) {
        for (int k = t; k < D; k += T) sdict[k] = bt.drow[k];
    }
    __syncthreads();

    const long long base = (long long)b * cap;
    const CQ *q = qty + base;
    const CD *d = disc + base;
    const int32_t *sh = ship + base;
    const float *p = price + base;
    const uint8_t *v = valid + base;
    const long long first = blockIdx.x * (long long)T + t;
    const long long stride = (long long)gridDim.x * T;
    float s = 0.0f, c = 0.0f;
    long long n = 0;
    long long done = 0;
    if (vec) {
        typedef typename Vec4<CQ>::T QV;
        typedef typename Vec4<CD>::T DV;
        const long long n4 = cap / 4;
        for (long long i = first; i < n4; i += stride) {
            const QV q4 = reinterpret_cast<const QV *>(q)[i];
            const DV d4 = reinterpret_cast<const DV *>(d)[i];
            const int4 s4 = reinterpret_cast<const int4 *>(sh)[i];
            const float4 p4 = reinterpret_cast<const float4 *>(p)[i];
            const uchar4 v4 = reinterpret_cast<const uchar4 *>(v)[i];
            row(bt, q4.x, d4.x, s4.x, p4.x, v4.x, s, c, n);
            row(bt, q4.y, d4.y, s4.y, p4.y, v4.y, s, c, n);
            row(bt, q4.z, d4.z, s4.z, p4.z, v4.z, s, c, n);
            row(bt, q4.w, d4.w, s4.w, p4.w, v4.w, s, c, n);
        }
        done = n4 * 4;
    }
    for (long long r = done + first; r < cap; r += stride) {
        row(bt, q[r], d[r], sh[r], p[r], v[r], s, c, n);
    }
    const long long at = ((long long)b * gridDim.x + blockIdx.x) * T + t;
    part_s[at] = s;
    part_c[at] = c;
    part_n[at] = n;
}

template <typename CQ, typename CD>
void launch(const void *qty, const void *disc, const void *ship,
            const void *price, const void *valid, const void *dicts, int D,
            const void *qhi, const void *dlo, const void *dhi, int slo,
            int shi, long long cap, int vec, void *part_s, void *part_c,
            void *part_n, dim3 grid, int threads, cudaStream_t st) {
    code_filter_sum_kernel<CQ, CD><<<grid, threads, 0, st>>>(
        static_cast<const CQ *>(qty), static_cast<const CD *>(disc),
        static_cast<const int32_t *>(ship), static_cast<const float *>(price),
        static_cast<const uint8_t *>(valid),
        static_cast<const float *>(dicts), D,
        static_cast<const int32_t *>(qhi), static_cast<const int32_t *>(dlo),
        static_cast<const int32_t *>(dhi), slo, shi, cap, vec,
        static_cast<float *>(part_s), static_cast<float *>(part_c),
        static_cast<long long *>(part_n));
}

}  // namespace

// qty_bytes / disc_bytes are the code widths, 1 (uint8) or 2 (uint16).
// dicts is [B, D] float32, qhi/dlo/dhi [B] int32.  vec is nonzero when
// cap % 4 == 0, ship and price are 16-byte aligned, valid 4-byte aligned
// and each code plate aligned to 4 * its code width.  The grid is
// (blocks_x, B) blocks of `threads`; part_s, part_c and part_n hold
// B * blocks_x * threads entries.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int code_filter_sum(const void *qty, int qty_bytes,
                               const void *disc, int disc_bytes,
                               const void *ship, const void *price,
                               const void *valid, const void *dicts, int D,
                               const void *qhi, const void *dlo,
                               const void *dhi, int slo, int shi, int B,
                               long long cap, int vec, void *part_s,
                               void *part_c, void *part_n, int blocks_x,
                               int threads, void *stream) {
    const dim3 grid(blocks_x, B);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (qty_bytes == 1 && disc_bytes == 1) {
        launch<uint8_t, uint8_t>(qty, disc, ship, price, valid, dicts, D, qhi,
                                 dlo, dhi, slo, shi, cap, vec, part_s, part_c,
                                 part_n, grid, threads, st);
    } else if (qty_bytes == 1 && disc_bytes == 2) {
        launch<uint8_t, uint16_t>(qty, disc, ship, price, valid, dicts, D,
                                  qhi, dlo, dhi, slo, shi, cap, vec, part_s,
                                  part_c, part_n, grid, threads, st);
    } else if (qty_bytes == 2 && disc_bytes == 1) {
        launch<uint16_t, uint8_t>(qty, disc, ship, price, valid, dicts, D,
                                  qhi, dlo, dhi, slo, shi, cap, vec, part_s,
                                  part_c, part_n, grid, threads, st);
    } else if (qty_bytes == 2 && disc_bytes == 2) {
        launch<uint16_t, uint16_t>(qty, disc, ship, price, valid, dicts, D,
                                   qhi, dlo, dhi, slo, shi, cap, vec, part_s,
                                   part_c, part_n, grid, threads, st);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
