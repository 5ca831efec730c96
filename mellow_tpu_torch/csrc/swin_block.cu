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
// is 8 x 8 (N = 64 tokens); hd = C / H <= 64; C a multiple of 8.
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
// The attention kernel: one block per (window, head, batch row), the
// window read in place from the (B, R, R, 3C) qkv; the core is
// window_core.cuh's, shared with TPU kernel #9 (window_attention.cu), with
// its head dimension padded to 32 (hd <= 32, every v0 stage) or 64 (hd 33
// to 64: HTSAT-large's stage 1 has hd = 64). Rounding follows the TPU
// kernel: q = bf16(q * bf16(hd^-0.5)); s = (q . k) + bias + mask in fp32;
// p = bf16(exp(s - max) / sum) (the softmax is normalised BEFORE the PV
// product here, unlike the decoder's attention); o = bf16(p @ v) with fp32
// accumulation.

#include "window_core.cuh"

namespace {

template <int HDP>
__global__ void __launch_bounds__(WIN_THREADS)
swin_window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ o, int R, int C, int H,
                        int hd, float scale) {
  __shared__ __align__(128) unsigned char smem[WindowSmem<HDP>::BYTES];
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nWw = R / WIN_WS;
  const size_t row0 = ((size_t)b * R + (w / nWw) * WIN_WS) * R + (w % nWw) * WIN_WS;
  window_attention_core<HDP, false>(qkv, o, row0, R, C, h, hd, scale,
                                    bias + (size_t)h * WIN_N * WIN_N,
                                    mask != nullptr ? mask + (size_t)w * WIN_N * WIN_N : nullptr,
                                    smem);
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
  if (R % WIN_WS != 0 || hd > 64 || hd * H != C) return (int)cudaErrorInvalidValue;
  int err;

  GemmArgs g = gemm_args(x, C, w_qkv, qkv_buf, M, 3 * C, C);
  g.gamma = static_cast<const bf16*>(ln1_s);
  g.beta = static_cast<const bf16*>(ln1_b);
  g.bias = static_cast<const bf16*>(b_qkv);
  g.eps = eps;
  if ((err = launch_gemm<NORM_LN, EPI_STORE>(g, st))) return err;

  const int nW = (R / WIN_WS) * (R / WIN_WS);
  const dim3 grid(nW, H, B);
  const bf16* qkv_in = static_cast<const bf16*>(qkv_buf);
  const float* bias_in = static_cast<const float*>(bias);
  const float* mask_in = static_cast<const float*>(mask);
  if (hd <= 32)
    swin_window_attn_kernel<32><<<grid, WIN_THREADS, 0, st>>>(
        qkv_in, bias_in, mask_in, static_cast<bf16*>(o_buf), R, C, H, hd, scale);
  else
    swin_window_attn_kernel<64><<<grid, WIN_THREADS, 0, st>>>(
        qkv_in, bias_in, mask_in, static_cast<bf16*>(o_buf), R, C, H, hd, scale);
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
