// The Swin window-attention core: the attention inside TPU kernel #8
// (pallas_swin_block.swin_block_fused; swin_block.cu launches it between
// the qkv and proj products) and the whole of TPU kernel #9
// (pallas_window_attention.window_attention_fused; window_attention.cu
// launches it alone).
//
// One block of 128 threads per (window, head): the window's 64 tokens of
// q, k and v for one head are staged in shared memory with the head
// dimension zero-padded to HDP (32 or 64, a whole number of 16-deep wmma
// steps; the padded columns add zeros to the scores and give output
// columns that are never stored). Then, on the tensor cores with fp32
// accumulation: S = Q K^T; s = S (* scale) + bias + mask in fp32; the
// fp32 softmax, normalised BEFORE the PV product and rounded to bf16,
// p = bf16(exp(s - max) / sum); o = bf16(p @ v).
//
// Where the scale applies (SCALE_SCORES):
//   false (#8): q = bf16(q * scale), scale = bf16(hd^-0.5), before Q K^T,
//               as pallas_swin_block rounds q to the compute dtype;
//   true  (#9): s = (Q K^T) * scale in fp32, scale = fp32(hd^-0.5):
//               pallas_window_attention multiplies bf16 q by an np.float32
//               scale, which JAX promotes to fp32, so q is never rounded;
//               the exact bf16 products summed in fp32 and then scaled
//               equal its sum of scaled products to fp32 rounding.
//
// Token n (row-major in the 8 x 8 window) of the block's window is row
// row0 + (n / 8) * row_step + n % 8 of qkv (row length 3C: q | k | v, head
// h at column h * hd of each) and of o (row length C): row_step is R for a
// window read in place from a (B, R, R, 3C) grid (#8) and 8 for packed
// (Bn, 64, 3C) windows (#9).

#pragma once

#include "gemm_bf16.cuh"

namespace {

constexpr int WIN_WS = 8;
constexpr int WIN_N = WIN_WS * WIN_WS;  // tokens per window
constexpr int WIN_THREADS = 128;        // four warps, 16 query rows each

template <int HDP>
struct WindowSmem {
  static_assert(HDP == 32 || HDP == 64, "head dim padded to 32 or 64");
  static constexpr int Q_LD = HDP + 8;   // bf16 q, k, v rows
  static constexpr int S_LD = WIN_N + 4; // fp32 scores
  static constexpr int P_LD = WIN_N + 8; // bf16 probabilities
  static constexpr int O_LD = HDP + 4;   // fp32 output
  static constexpr int QKV_BYTES = WIN_N * Q_LD * 2;
  static constexpr int S_BYTES = WIN_N * S_LD * 4;
  // Q, K, V, then the scores; the output reuses the scores' space and the
  // probabilities reuse Q and K's (neither is read after Q K^T).
  static constexpr int BYTES = 3 * QKV_BYTES + S_BYTES;
  static_assert(WIN_N * O_LD * 4 <= S_BYTES, "output fits in the scores' space");
  static_assert(WIN_N * P_LD * 2 <= 2 * QKV_BYTES, "probabilities fit in Q and K's space");
  static_assert(BYTES <= 48 * 1024, "static shared memory");
};

template <int HDP, bool SCALE_SCORES>
__device__ __forceinline__ void window_attention_core(
    const bf16* __restrict__ qkv, bf16* __restrict__ o, size_t row0, int row_step, int C, int h,
    int hd, float scale, const float* __restrict__ bias_h, const float* __restrict__ mask_w,
    unsigned char* smem) {
  using L = WindowSmem<HDP>;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + WIN_N * L::Q_LD;
  bf16* Vs = Ks + WIN_N * L::Q_LD;
  float* Ss = reinterpret_cast<float*>(Vs + WIN_N * L::Q_LD);
  bf16* Ps = Qs;
  float* Os = Ss;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int e = tid; e < WIN_N * HDP; e += WIN_THREADS) {
    const int n = e / HDP;
    const int d = e % HDP;
    bf16 zq = __float2bfloat16(0.f), zk = zq, zv = zq;
    if (d < hd) {
      const size_t row = row0 + (size_t)(n / WIN_WS) * row_step + n % WIN_WS;
      const bf16* src = qkv + row * 3 * C + h * hd + d;
      zq = SCALE_SCORES ? src[0] : __float2bfloat16(bf2f(src[0]) * scale);
      zk = src[C];
      zv = src[2 * C];
    }
    Qs[n * L::Q_LD + d] = zq;
    Ks[n * L::Q_LD + d] = zk;
    Vs[n * L::Q_LD + d] = zv;
  }
  __syncthreads();

  // S = Q K^T: warp w owns query rows [16 w, 16 w + 16).
#pragma unroll
  for (int j = 0; j < WIN_N / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HDP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qs + warp * 16 * L::Q_LD + kk, L::Q_LD);
      wmma::load_matrix_sync(fb, Ks + j * 16 * L::Q_LD + kk, L::Q_LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Ss + warp * 16 * L::S_LD + j * 16, acc, L::S_LD, wmma::mem_row_major);
  }
  __syncthreads();

  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s0 = Ss[r * L::S_LD + lane];
    float s1 = Ss[r * L::S_LD + lane + 32];
    if (SCALE_SCORES) {
      s0 *= scale;
      s1 *= scale;
    }
    s0 += bias_h[r * WIN_N + lane];
    s1 += bias_h[r * WIN_N + lane + 32];
    if (mask_w != nullptr) {
      s0 += mask_w[r * WIN_N + lane];
      s1 += mask_w[r * WIN_N + lane + 32];
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = expf(s0 - m);
    const float e1 = expf(s1 - m);
    const float sum = warp_sum(e0 + e1);
    Ps[r * L::P_LD + lane] = __float2bfloat16(e0 / sum);
    Ps[r * L::P_LD + lane + 32] = __float2bfloat16(e1 / sum);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[HDP / 16];
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < WIN_N; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, Ps + warp * 16 * L::P_LD + kk, L::P_LD);
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Vs + kk * L::Q_LD + j * 16, L::Q_LD);
      wmma::mma_sync(oacc[j], fa, fb, oacc[j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j)
    wmma::store_matrix_sync(Os + warp * 16 * L::O_LD + j * 16, oacc[j], L::O_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < WIN_N * HDP; e += WIN_THREADS) {
    const int n = e / HDP;
    const int d = e % HDP;
    if (d < hd) {
      const size_t row = row0 + (size_t)(n / WIN_WS) * row_step + n % WIN_WS;
      o[row * C + h * hd + d] = __float2bfloat16(Os[n * L::O_LD + d]);
    }
  }
}

}  // namespace
