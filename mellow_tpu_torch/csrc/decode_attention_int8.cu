// GQA attention for one decode step over an int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_decode_attention.py
// (flash_gqa_decode_tiled, the group-tiled int8 kernel, whose math is
// flash_gqa_decode's int8 branch): per query head, q is quantized to int8
// with its own scale; scores are int8 x int8 dots with the per-position k
// scales folded in after; the flush window's pending rows and the step's
// own row ride in bf16 as E extra positions (the TPU kernel's ex_ref rows,
// pallas_decode_attention._kernel_tiled), sharing the score max and the
// fp32 sum; the softmax weights times the per-position v scales are
// re-quantized to int8 (by truncation) for an int8 x int8 value dot; the
// extras' value sum, bf16(exp) times the bf16 rows in fp32, is added and
// the sum is normalised.
//
// Contract: q (B, H, hd) bf16, roped; k8 and v8 are one layer of the
// port's int8 cache, (B, S_max, KV, hd), batch stride kv_bstride and
// position stride kv_sstride (elements, multiples of 16); k_scale and
// v_scale (B, S_max) fp32 with batch stride sc_bstride; k_extra and
// v_extra (B, E, KV, hd) bf16 with batch stride ex_bstride (elements) and
// contiguous (E, KV, hd) rows, 1 <= E <= 8, every row live: the window's
// pending rows, then this step's; positions [0, n) of the cache are
// attended, plus the E extra rows. out (B, H, hd) bf16. hd is a multiple
// of 16, at most 128; H / KV <= 8. With E = 1 the arithmetic is the one
// of the single-extra-row kernel this contract replaced, operation for
// operation.
//
// What bounds it: bytes. A step reads a layer's valid int8 cache and its
// scales, 2 * B * n * (KV * hd + 4) bytes (at v0, B=1, n ~ 400: 0.15 MB),
// against ~4 integer operations per byte, far below what the tensor cores
// need, and at B=1 a launch costs more than the transfer.
//
// What the design does about it: one block per (KV group, batch row), so
// the group's query heads share every cache row read (the GQA sharing the
// TPU kernel gets from its group tiling, without its zero lanes). Scores:
// a thread per position, 16-byte loads of the k8 row and __dp4a against
// the packed int8 queries, exact int32 sums. The block reductions (score
// max, exp sum, max of w) run through shared memory. Value side: threads
// split positions into groups and the row into 16-byte column chunks,
// accumulate w8 * v8 in int32 (exact in any order) with four loads in
// flight, and combine the partial sums in shared memory. Splitting long
// caches over several blocks per group is later work.

#include "gemm_bf16.cuh"

namespace {

constexpr int ITHREADS = 128;
constexpr int IMAX_EXTRA = 8;

__device__ __forceinline__ void unpack16_s8(int4 u, int* f) {
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (int)(signed char)((w[i] >> (8 * j)) & 0xff);
}

template <int REP>
__global__ void __launch_bounds__(ITHREADS)
decode_gqa_int8_kernel(const bf16* __restrict__ q, const signed char* __restrict__ kc,
                       const signed char* __restrict__ vc, const float* __restrict__ ksc,
                       const float* __restrict__ vsc, const bf16* __restrict__ kex,
                       const bf16* __restrict__ vex, bf16* __restrict__ out, int H, int KV,
                       int hd, int n, int E, long long kv_bstride, int kv_sstride,
                       long long sc_bstride, long long ex_bstride, float scale,
                       float score_scale) {
  extern __shared__ __align__(16) unsigned char ism[];
  const int chunks = hd / 16;
  const int G = ITHREADS / chunks;
  // Every 16-byte read below stays aligned: hd is a multiple of 16.
  int* part = reinterpret_cast<int*>(ism);                                // REP x G x hd
  signed char* q8s = reinterpret_cast<signed char*>(part + REP * G * hd);  // REP x hd
  float* ss = reinterpret_cast<float*>(q8s + REP * hd);                   // REP x n: s, then w
  signed char* w8s = reinterpret_cast<signed char*>(ss + REP * n);         // REP x n
  __shared__ float wred[ITHREADS / 32][REP];
  __shared__ float qmax_s[REP], m_s[REP], d_s[REP], wmax_s[REP];
  __shared__ float sx_s[REP][IMAX_EXTRA], ex_s[REP][IMAX_EXTRA];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* qb = q + ((size_t)b * H + (size_t)g * REP) * hd;
  const signed char* kb = kc + (size_t)b * kv_bstride + (size_t)g * hd;
  const signed char* vb = vc + (size_t)b * kv_bstride + (size_t)g * hd;
  const float* ksb = ksc + (size_t)b * sc_bstride;
  const float* vsb = vsc + (size_t)b * sc_bstride;
  // Extra row e of this group: kxb + e * KV * hd.
  const bf16* kxb = kex + (size_t)b * ex_bstride + (size_t)g * hd;
  const bf16* vxb = vex + (size_t)b * ex_bstride + (size_t)g * hd;
  const int ex_sstride = KV * hd;

  // Per head: max|q|, and per extra row its score (fp32 from bf16).
  for (int r = warp; r < REP; r += ITHREADS / 32) {
    float amax = 0.f;
    for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(bf2f(qb[r * hd + d])));
    amax = warp_max(amax);
    for (int e = 0; e < E; ++e) {
      const bf16* kxr = kxb + (size_t)e * ex_sstride;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float qv = bf2f(qb[r * hd + d]);
        dot += qv * bf2f(kxr[d]);  // bf16 x bf16 is exact in fp32
      }
      dot = warp_sum(dot);
      if (lane == 0) sx_s[r][e] = dot * scale;
    }
    if (lane == 0) qmax_s[r] = fmaxf(amax, 1e-8f);
  }
  __syncthreads();
  for (int i = tid; i < REP * hd; i += ITHREADS) {
    const float inv = 127.f / qmax_s[i / hd];
    q8s[i] = (signed char)(int)rintf(__fmul_rn(bf2f(qb[i]), inv));
  }
  __syncthreads();

  // Scores: a thread per position, all heads of the group at once.
  float qc[REP], lmax[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    qc[r] = __fmul_rn(qmax_s[r], score_scale);
    lmax[r] = -1e30f;
  }
  for (int p = tid; p < n; p += ITHREADS) {
    int acc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r] = 0;
    const signed char* kr = kb + (size_t)p * kv_sstride;
    for (int d = 0; d < hd; d += 16) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(kr + d));
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int4 q4 = *reinterpret_cast<const int4*>(q8s + r * hd + d);
        acc[r] = __dp4a(k4.x, q4.x, acc[r]);
        acc[r] = __dp4a(k4.y, q4.y, acc[r]);
        acc[r] = __dp4a(k4.z, q4.z, acc[r]);
        acc[r] = __dp4a(k4.w, q4.w, acc[r]);
      }
    }
    const float ks = ksb[p];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float s = __fmul_rn(__fmul_rn((float)acc[r], qc[r]), ks);
      ss[r * n + p] = s;
      lmax[r] = fmaxf(lmax[r], s);
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float m = warp_max(lmax[r]);
    if (lane == 0) wred[warp][r] = m;
  }
  __syncthreads();
  if (tid < REP) {
    float m = sx_s[tid][0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, sx_s[tid][e]);
    for (int w = 0; w < ITHREADS / 32; ++w) m = fmaxf(m, wred[w][tid]);
    m_s[tid] = m;
  }
  __syncthreads();

  // e = exp(s - m), its sum, and w = e * v_scale with its max.
  float lsum[REP], lw[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    lsum[r] = 0.f;
    lw[r] = 0.f;
  }
  for (int p = tid; p < n; p += ITHREADS) {
    const float vs = vsb[p];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float e = expf(ss[r * n + p] - m_s[r]);
      lsum[r] += e;
      const float w = __fmul_rn(e, vs);
      ss[r * n + p] = w;
      lw[r] = fmaxf(lw[r], w);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float s = warp_sum(lsum[r]);
    if (lane == 0) wred[warp][r] = s;
  }
  __syncthreads();
  if (tid < REP) {
    float s = 0.f;
    for (int w = 0; w < ITHREADS / 32; ++w) s += wred[w][tid];
    // The TPU kernel's sum(e) + sum(e_extra); one extra row adds its exp.
    float xs = 0.f;
    for (int e = 0; e < E; ++e) {
      const float ex = expf(sx_s[tid][e] - m_s[tid]);
      ex_s[tid][e] = ex;
      xs += ex;
    }
    d_s[tid] = s + xs;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float m = warp_max(lw[r]);
    if (lane == 0) wred[warp][r] = m;
  }
  __syncthreads();
  if (tid < REP) {
    float m = 0.f;
    for (int w = 0; w < ITHREADS / 32; ++w) m = fmaxf(m, wred[w][tid]);
    wmax_s[tid] = fmaxf(m, 1e-30f);
  }
  __syncthreads();
  // w8 = trunc(w * 127 / wmax): w >= 0, and the cast truncates as the TPU
  // kernel's astype(int8) does.
  for (int i = tid; i < REP * n; i += ITHREADS) {
    const float inv = 127.f / wmax_s[i / n];
    w8s[i] = (signed char)(int)__fmul_rn(ss[i], inv);
  }
  __syncthreads();

  // Value side: thread (grp, chunk) sums w8 * v8 over positions grp,
  // grp + G, ... for 16 columns, four 16-byte loads in flight.
  const int grp = tid / chunks;
  const int c16 = (tid % chunks) * 16;
  int oacc[REP][16];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) oacc[r][j] = 0;
  int p = grp;
  for (; p + 3 * G < n; p += 4 * G) {
    int4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = __ldg(reinterpret_cast<const int4*>(vb + (size_t)(p + i * G) * kv_sstride + c16));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int f[16];
      unpack16_s8(u[i], f);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int w = w8s[r * n + p + i * G];
#pragma unroll
        for (int j = 0; j < 16; ++j) oacc[r][j] += w * f[j];
      }
    }
  }
  for (; p < n; p += G) {
    int f[16];
    unpack16_s8(__ldg(reinterpret_cast<const int4*>(vb + (size_t)p * kv_sstride + c16)), f);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const int w = w8s[r * n + p];
#pragma unroll
      for (int j = 0; j < 16; ++j) oacc[r][j] += w * f[j];
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) part[(r * G + grp) * hd + c16 + j] = oacc[r][j];
  __syncthreads();
  for (int i = tid; i < REP * hd; i += ITHREADS) {
    const int r = i / hd;
    const int dd = i % hd;
    int s = 0;
    for (int gg = 0; gg < G; ++gg) s += part[(r * G + gg) * hd + dd];
    const float wm = wmax_s[r] / 127.f;
    // The extras' value sum: bf16(exp) x bf16 is exact in fp32, the adds
    // round in row order.
    float xv = 0.f;
    for (int e = 0; e < E; ++e)
      xv = __fadd_rn(xv, __fmul_rn(bf16_round(ex_s[r][e]), bf2f(vxb[(size_t)e * ex_sstride + dd])));
    const float o = __fadd_rn(__fmul_rn((float)s, wm), xv);
    out[((size_t)b * H + (size_t)g * REP + r) * hd + dd] = __float2bfloat16(o / d_s[r]);
  }
}

template <int REP>
int launch_int8_decode(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                       const void* kex, const void* vex, void* out, int B, int H, int KV, int hd,
                       int n, int E, long long kv_bstride, int kv_sstride, long long sc_bstride,
                       long long ex_bstride, cudaStream_t stream) {
  const int G = ITHREADS / (hd / 16);
  const size_t smem = (size_t)REP * G * hd * 4 + (size_t)REP * n * 4 + (size_t)REP * hd +
                      (size_t)REP * n;
  cudaError_t err = cudaFuncSetAttribute(decode_gqa_int8_kernel<REP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)hd);
  decode_gqa_int8_kernel<REP><<<dim3(KV, B), ITHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const signed char*>(k),
      static_cast<const signed char*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const bf16*>(kex),
      static_cast<const bf16*>(vex), static_cast<bf16*>(out), H, KV, hd, n, E, kv_bstride,
      kv_sstride, sc_bstride, ex_bstride, scale, scale / 127.f);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one kernel on `stream`; returns the cudaError_t, 0 on success.
// Does not synchronise.
extern "C" int mellow_decode_attention_int8(const void* q, const void* k, const void* v,
                                            const void* ks, const void* vs, const void* kex,
                                            const void* vex, void* out, int B, int H, int KV,
                                            int hd, int n, int E, long long kv_bstride,
                                            int kv_sstride, long long sc_bstride,
                                            long long ex_bstride, void* stream) {
  const int rep = H / KV;
  if (rep * KV != H || hd % 16 != 0 || hd > 128 || n < 1 || kv_sstride % 16 != 0 ||
      kv_bstride % 16 != 0 || E < 1 || E > IMAX_EXTRA)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MELLOW_INT8_DECODE(R) \
  case R:                     \
    return launch_int8_decode<R>(q, k, v, ks, vs, kex, vex, out, B, H, KV, hd, n, E, kv_bstride, \
                                 kv_sstride, sc_bstride, ex_bstride, st);
  switch (rep) {
    MELLOW_INT8_DECODE(1)
    MELLOW_INT8_DECODE(2)
    MELLOW_INT8_DECODE(3)
    MELLOW_INT8_DECODE(4)
    MELLOW_INT8_DECODE(5)
    MELLOW_INT8_DECODE(6)
    MELLOW_INT8_DECODE(7)
    MELLOW_INT8_DECODE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MELLOW_INT8_DECODE
}
