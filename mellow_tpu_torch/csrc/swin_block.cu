// One Swin Transformer block for Hopper (sm_90a), bf16, eval.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_swin_block.py
// (swin_block_fused): LN1; qkv + bias; window MHA with the relative-position
// bias and the -100 SW-MSA mask; proj + bias; residual; LN2; fc1 + bias;
// tanh-GELU (the TPU kernel's approximation, not erf); fc2 + bias; residual.
// The cyclic rolls of shifted blocks stay outside, as there.
//
// Contract: x (B, R, R, C) bf16, already rolled; ln1/ln2 scale and bias
// (C); w_qkv (C, 3C) + b_qkv (3C); w_proj (C, C) + b_proj; w_fc1 (C, 4C) +
// b_fc1; w_fc2 (4C, C) + b_fc2; bias (H, 64, 64) fp32 relative-position
// bias per head; mask (nW, 64, 64) fp32 or null; scratch qkv (M, 3C),
// o (M, C), x1 (M, C), hid (M, 4C) with M = B*R*R; out (M, C). The window
// is 8 x 8 (N = 64 tokens); hd = C / H <= 32; C a multiple of 8.
//
// What bounds it: at stage 1 of v0 (B=1, R=64, C=96, H=4) the block moves
// ~6 MB (x, the qkv, hidden and output activations, weights) and does
// ~0.5 GFLOP; bf16 tensor cores would finish the operations in ~0.5 us,
// so it is bound by bytes (~2 us at 3.35 TB/s) and, at this size, by the
// latency of its five launches.
//
// What the design does about it: the shared tiled GEMM (gemm_bf16.cuh)
// with the LayerNorm as a prologue and bias / residual / GELU as
// epilogues, so neither LayerNorm output reaches device memory:
//   1. qkv = bf16(LN1(x) @ w_qkv + b_qkv)
//   2. o = window attention (the kernel below), windows read in place from
//      the (B, R, R, 3C) qkv by index arithmetic (no partition copy)
//   3. x1 = x + bf16(o @ w_proj + b_proj)
//   4. hid = bf16(gelu_tanh(bf16(LN2(x1) @ w_fc1 + b_fc1)))
//   5. out = x1 + bf16(hid @ w_fc2 + b_fc2)
//
// The attention kernel: one block per (window, head, batch row). hd = 24
// is not a multiple of the 16-deep wmma step, so q, k and v are staged with
// their head dimension zero-padded to 32 in shared memory; the padded
// columns add zeros to the scores and produce output columns that are never
// stored. Rounding follows the TPU kernel: q = bf16(q * bf16(hd^-0.5));
// s = (q . k) + bias + mask in fp32; p = bf16(exp(s - max) / sum) (the
// softmax is normalised BEFORE the PV product here, unlike the decoder's
// attention); o = bf16(p @ v) with fp32 accumulation.

#include "gemm_bf16.cuh"

namespace {

constexpr int SW_WS = 8;
constexpr int SW_N = SW_WS * SW_WS;  // tokens per window
constexpr int SW_HDP = 32;           // head dim padded to two wmma steps
constexpr int SW_THREADS = 128;
constexpr int SQ_LD = SW_HDP + 8;  // bf16
constexpr int SS_LD = SW_N + 4;    // fp32
constexpr int SP_LD = SW_N + 8;    // bf16
constexpr int SO_LD = SW_HDP + 4;  // fp32

__global__ void __launch_bounds__(SW_THREADS)
swin_window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ o, int R, int C, int H,
                        int hd, float scale) {
  __shared__ __align__(128) bf16 Qs[SW_N * SQ_LD];
  __shared__ __align__(128) bf16 Ks[SW_N * SQ_LD];
  __shared__ __align__(128) bf16 Vs[SW_N * SQ_LD];
  __shared__ __align__(128) float Ss[SW_N * SS_LD];  // scores, later O
  __shared__ __align__(128) bf16 Ps[SW_N * SP_LD];

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nWw = R / SW_WS;
  const int wy = w / nWw;
  const int wx = w % nWw;

  for (int e = tid; e < SW_N * SW_HDP; e += SW_THREADS) {
    const int n = e / SW_HDP;
    const int d = e % SW_HDP;
    bf16 zq = __float2bfloat16(0.f), zk = zq, zv = zq;
    if (d < hd) {
      const size_t row = ((size_t)b * R + wy * SW_WS + n / SW_WS) * R + wx * SW_WS + n % SW_WS;
      const bf16* src = qkv + row * 3 * C + h * hd + d;
      zq = __float2bfloat16(bf2f(src[0]) * scale);
      zk = src[C];
      zv = src[2 * C];
    }
    Qs[n * SQ_LD + d] = zq;
    Ks[n * SQ_LD + d] = zk;
    Vs[n * SQ_LD + d] = zv;
  }
  __syncthreads();

  // S = Q K^T: warp w owns query rows [16 w, 16 w + 16).
#pragma unroll
  for (int j = 0; j < SW_N / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < SW_HDP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qs + warp * 16 * SQ_LD + kk, SQ_LD);
      wmma::load_matrix_sync(fb, Ks + j * 16 * SQ_LD + kk, SQ_LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Ss + warp * 16 * SS_LD + j * 16, acc, SS_LD, wmma::mem_row_major);
  }
  __syncthreads();

  const float* bh = bias + (size_t)h * SW_N * SW_N;
  const float* mw = mask != nullptr ? mask + (size_t)w * SW_N * SW_N : nullptr;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s0 = Ss[r * SS_LD + lane] + bh[r * SW_N + lane];
    float s1 = Ss[r * SS_LD + lane + 32] + bh[r * SW_N + lane + 32];
    if (mw != nullptr) {
      s0 += mw[r * SW_N + lane];
      s1 += mw[r * SW_N + lane + 32];
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = expf(s0 - m);
    const float e1 = expf(s1 - m);
    const float sum = warp_sum(e0 + e1);
    Ps[r * SP_LD + lane] = __float2bfloat16(e0 / sum);
    Ps[r * SP_LD + lane + 32] = __float2bfloat16(e1 / sum);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[SW_HDP / 16];
#pragma unroll
  for (int j = 0; j < SW_HDP / 16; ++j) wmma::fill_fragment(oacc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < SW_N; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, Ps + warp * 16 * SP_LD + kk, SP_LD);
#pragma unroll
    for (int j = 0; j < SW_HDP / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Vs + kk * SQ_LD + j * 16, SQ_LD);
      wmma::mma_sync(oacc[j], fa, fb, oacc[j]);
    }
  }
  __syncthreads();
  float* Os = Ss;
#pragma unroll
  for (int j = 0; j < SW_HDP / 16; ++j)
    wmma::store_matrix_sync(Os + warp * 16 * SO_LD + j * 16, oacc[j], SO_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < SW_N * SW_HDP; e += SW_THREADS) {
    const int n = e / SW_HDP;
    const int d = e % SW_HDP;
    if (d < hd) {
      const size_t row = ((size_t)b * R + wy * SW_WS + n / SW_WS) * R + wx * SW_WS + n % SW_WS;
      o[row * C + h * hd + d] = __float2bfloat16(Os[n * SO_LD + d]);
    }
  }
}

}  // namespace

// Launches the five steps on `stream`; returns the first cudaError_t, 0 on
// success. `scale` is hd^-0.5 already rounded to bf16 by the caller. Does
// not synchronise.
extern "C" int mellow_swin_block(const void* x, const void* ln1_s, const void* ln1_b,
                                 const void* w_qkv, const void* b_qkv, const void* w_proj,
                                 const void* b_proj, const void* ln2_s, const void* ln2_b,
                                 const void* w_fc1, const void* b_fc1, const void* w_fc2,
                                 const void* b_fc2, const void* bias, const void* mask,
                                 void* qkv_buf, void* o_buf, void* x1_buf, void* hid_buf,
                                 void* out, int B, int R, int C, int H, float scale, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * R * R;
  const int hd = C / H;
  if (R % SW_WS != 0 || hd > SW_HDP || hd * H != C) return (int)cudaErrorInvalidValue;
  int err;

  GemmArgs g = gemm_args(x, C, w_qkv, qkv_buf, M, 3 * C, C);
  g.gamma = static_cast<const bf16*>(ln1_s);
  g.beta = static_cast<const bf16*>(ln1_b);
  g.bias = static_cast<const bf16*>(b_qkv);
  g.eps = eps;
  if ((err = launch_gemm<NORM_LN, EPI_STORE>(g, st))) return err;

  const int nW = (R / SW_WS) * (R / SW_WS);
  swin_window_attn_kernel<<<dim3(nW, H, B), SW_THREADS, 0, st>>>(
      static_cast<const bf16*>(qkv_buf), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(o_buf), R, C, H, hd, scale);
  if ((err = (int)cudaGetLastError())) return err;

  GemmArgs gp = gemm_args(o_buf, C, w_proj, x1_buf, M, C, C);
  gp.bias = static_cast<const bf16*>(b_proj);
  gp.resid = static_cast<const bf16*>(x);
  gp.ld_resid = C;
  if ((err = launch_gemm<NORM_NONE, EPI_RESID>(gp, st))) return err;

  GemmArgs g1 = gemm_args(x1_buf, C, w_fc1, hid_buf, M, 4 * C, C);
  g1.gamma = static_cast<const bf16*>(ln2_s);
  g1.beta = static_cast<const bf16*>(ln2_b);
  g1.bias = static_cast<const bf16*>(b_fc1);
  g1.eps = eps;
  if ((err = launch_gemm<NORM_LN, EPI_GELU>(g1, st))) return err;

  GemmArgs g2 = gemm_args(hid_buf, 4 * C, w_fc2, out, M, C, 4 * C);
  g2.bias = static_cast<const bf16*>(b_fc2);
  g2.resid = static_cast<const bf16*>(x1_buf);
  g2.ld_resid = C;
  return launch_gemm<NORM_NONE, EPI_RESID>(g2, st);
}
