// GQA attention for one decode step for Hopper (sm_90a), bf16 cache.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_decode_attention.py
// (flash_gqa_decode): one query token per batch row attends over the
// cached positions; scores and softmax in fp32; the unnormalised
// exp(s - max) is rounded to bf16 before the PV product, which accumulates
// in fp32 and is then divided by the fp32 sum (pallas_decode_attention.py
// _kernel, the bf16-cache branch).
//
// Contract: q (B, H, hd) bf16, roped; k and v are one layer of the port's
// cache, (B, S_max, KV, hd) bf16 with batch stride kv_bstride and position
// stride kv_sstride (elements); positions [0, n) are attended (the caller
// has already written this step's k/v at n - 1, so the TPU kernel's
// "extras" are simply the last cached position here); out (B, H, hd) bf16.
// hd is a multiple of 8, at most 128, and hd / 8 divides 128; H / KV <= 8.
//
// What bounds it: bytes. Each step reads the whole valid cache of a layer,
// 2 * B * n * KV * hd * 2 bytes (at v0, B=1, n ~ 400: 0.3 MB per layer),
// against ~4 operations per byte: far below the ~295 the tensor cores need,
// so no tensor cores here. At B=1 the launch costs more than the transfer.
//
// What the design does about it: one block per (KV head, batch row) reads
// that head's K rows once with 16-byte loads, a thread per position,
// scoring all H/KV query heads of the group against each row (the GQA
// sharing the TPU kernel gets from its block-diagonal dense queries,
// without the zero lanes); scores live in shared memory. For the PV sum the
// block's threads split the positions into 16 groups (at hd = 64) and the
// row into 16-byte column chunks, keep four V loads in flight each, and
// combine the partial sums in shared memory. Splitting long caches over
// several blocks per head (a two-pass flash-decoding layout), so that B=1
// fills more than KV SMs, is later work.

#include "gemm_bf16.cuh"

namespace {

constexpr int DTHREADS = 128;
constexpr int DMAX_REP = 8;

__global__ void __launch_bounds__(DTHREADS)
decode_gqa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, bf16* __restrict__ out, int H, int KV, int hd,
                  int n, long long kv_bstride, int kv_sstride, float scale) {
  extern __shared__ __align__(16) float dsm[];
  __shared__ float wred[DTHREADS / 32][DMAX_REP];
  __shared__ float row_max[DMAX_REP];
  __shared__ float row_sum[DMAX_REP];
  const int rep = H / KV;
  float* qs = dsm;              // rep x hd
  float* ss = qs + rep * hd;    // rep x n: scores, then exp
  float* part = ss + rep * n;   // rep x 8 * DTHREADS partial PV sums

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* qb = q + ((size_t)b * H + (size_t)g * rep) * hd;
  const bf16* kb = kc + (size_t)b * kv_bstride + (size_t)g * hd;
  const bf16* vb = vc + (size_t)b * kv_bstride + (size_t)g * hd;

  for (int i = tid; i < rep * hd; i += DTHREADS) qs[i] = bf2f(qb[i]);
  __syncthreads();

  // Scores: thread per position, all query heads of the group at once.
  float lmax[DMAX_REP];
#pragma unroll
  for (int r = 0; r < DMAX_REP; ++r) lmax[r] = -1e30f;
  for (int p = tid; p < n; p += DTHREADS) {
    float acc[DMAX_REP];
#pragma unroll
    for (int r = 0; r < DMAX_REP; ++r) acc[r] = 0.f;
    const bf16* kr = kb + (size_t)p * kv_sstride;
    for (int d = 0; d < hd; d += 8) {
      float f[8];
      unpack8(ldg16(kr + d), f);
#pragma unroll
      for (int r = 0; r < DMAX_REP; ++r)
        if (r < rep)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r] = fmaf(qs[r * hd + d + j], f[j], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < DMAX_REP; ++r)
      if (r < rep) {
        const float s = acc[r] * scale;
        ss[r * n + p] = s;
        lmax[r] = fmaxf(lmax[r], s);
      }
  }
#pragma unroll
  for (int r = 0; r < DMAX_REP; ++r) {
    const float m = warp_max(lmax[r]);
    if (lane == 0 && r < rep) wred[warp][r] = m;
  }
  __syncthreads();
  if (tid < rep) {
    float m = wred[0][tid];
    for (int w = 1; w < DTHREADS / 32; ++w) m = fmaxf(m, wred[w][tid]);
    row_max[tid] = m;
  }
  __syncthreads();

  float lsum[DMAX_REP];
#pragma unroll
  for (int r = 0; r < DMAX_REP; ++r) lsum[r] = 0.f;
  for (int p = tid; p < n; p += DTHREADS) {
#pragma unroll
    for (int r = 0; r < DMAX_REP; ++r)
      if (r < rep) {
        const float e = expf(ss[r * n + p] - row_max[r]);
        ss[r * n + p] = e;
        lsum[r] += e;
      }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < DMAX_REP; ++r) {
    const float s = warp_sum(lsum[r]);
    if (lane == 0 && r < rep) wred[warp][r] = s;
  }
  __syncthreads();
  if (tid < rep) {
    float s = 0.f;
    for (int w = 0; w < DTHREADS / 32; ++w) s += wred[w][tid];
    row_sum[tid] = s;
  }

  // PV: thread (grp, c) owns the 8 columns [8c, 8c + 8) and sums positions
  // grp, grp + G, ... with 16-byte V loads, four positions in flight per
  // iteration (a loop that waits on one load at a time measured 0.13 ms per
  // launch at B=1, n=389: the first version of this kernel).
  const int chunks = hd / 8;
  const int G = DTHREADS / chunks;
  const int grp = tid / chunks;
  const int c8 = (tid % chunks) * 8;
  float oacc[DMAX_REP][8];
#pragma unroll
  for (int r = 0; r < DMAX_REP; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) oacc[r][j] = 0.f;
  int p = grp;
  for (; p + 3 * G < n; p += 4 * G) {
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = ldg16(vb + (size_t)(p + i * G) * kv_sstride + c8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[8];
      unpack8(u[i], f);
#pragma unroll
      for (int r = 0; r < DMAX_REP; ++r)
        if (r < rep) {
          const float e = bf16_round(ss[r * n + p + i * G]);
#pragma unroll
          for (int j = 0; j < 8; ++j) oacc[r][j] = fmaf(e, f[j], oacc[r][j]);
        }
    }
  }
  for (; p < n; p += G) {
    float f[8];
    unpack8(ldg16(vb + (size_t)p * kv_sstride + c8), f);
#pragma unroll
    for (int r = 0; r < DMAX_REP; ++r)
      if (r < rep) {
        const float e = bf16_round(ss[r * n + p]);
#pragma unroll
        for (int j = 0; j < 8; ++j) oacc[r][j] = fmaf(e, f[j], oacc[r][j]);
      }
  }
  // part[r][grp][col]: rep x G x hd partial sums.
#pragma unroll
  for (int r = 0; r < DMAX_REP; ++r)
    if (r < rep)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[(r * G + grp) * hd + c8 + j] = oacc[r][j];
  __syncthreads();
  for (int i = tid; i < rep * hd; i += DTHREADS) {
    const int r = i / hd;
    const int dd = i % hd;
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += part[(r * G + gg) * hd + dd];
    out[((size_t)b * H + (size_t)g * rep + r) * hd + dd] = __float2bfloat16(s / row_sum[r]);
  }
}

}  // namespace

// Launches one kernel on `stream`; returns the cudaError_t, 0 on success.
// Does not synchronise.
extern "C" int mellow_decode_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int KV, int hd, int n, long long kv_bstride,
                                       int kv_sstride, void* stream) {
  const int rep = H / KV;
  if (rep > DMAX_REP || rep * KV != H || hd % 8 != 0 || hd > 128 || DTHREADS % (hd / 8) != 0 ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rep * (hd + n + 8 * DTHREADS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_gqa_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_gqa_kernel<<<dim3(KV, B), DTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, KV, hd, n, kv_bstride, kv_sstride, 1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}
