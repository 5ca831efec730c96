// The W8A8 prefill MLP half of a Llama layer for Hopper (sm_90a).
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_mlp_block.py
// (fused_mlp_block_w8a8, body _kernel_w8a8): fp32 RMSNorm, then per-row
// int8 activations (_rowquant); int8 gate and up products with int32 sums;
// silu(gate * hs * sg) * (up * hs * su) in fp32; per-row int8 of that
// product over I; the int8 down product times its row and column scales,
// rounded to bf16; the residual.
//
// Contract: x (M, D) bf16 with M = B*S rows; ln (D) bf16; w_gate and w_up
// (D, I), w_down (I, D) int8 with per-column bf16 scales sg, su, sd;
// scratch h8 (M, D) int8, hs (M) fp32, prod (M, I) fp32, p8 (M, I) int8,
// ps (M) fp32; out (M, D) bf16. D and I are multiples of 16.
//
// What bounds it: at the v0 prefill (M=389, D=576, I=1536) the block is
// 2.06 G int8 operations against 2.65 MB of int8 weights: ~1 us at the
// card's int8 tensor-core peak and ~0.8 us of HBM reads, so on paper
// compute and bytes are close; at B=1 the launch chain's latency and
// partial SM fill (7 row tiles) dominate.
//
// What the design does about it, for now: four launches on one stream,
// every product on the tensor cores (wmma int8, exact int32 sums,
// gemm_int8.cuh), the scales folded in after the sums:
//   1. h8, hs = rowquant(rms_norm(x))                  one warp per row
//   2. prod = silu(h8 @ wg * hs * sg) * (h8 @ wu * hs * su)
//      one kernel computes both products on the same A tile, fp32 out
//   3. p8, ps = rowquant(prod)                         over all I columns
//   4. out = x + bf16(p8 @ wd * ps * sd)               residual epilogue
// The product's row max spans all I columns, i.e. all 24 column tiles of
// step 2, so its quantizer is a pass of its own; the (M, I) fp32 product
// goes through device memory (2.4 MB at B=1, L2-resident). Keeping it on
// chip means one persistent kernel, later work.

#include "gemm_int8.cuh"

// Launches the chain on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_mlp_block_w8a8(const void* x, const void* ln, const void* wg, const void* sg,
                                     const void* wu, const void* su, const void* wd,
                                     const void* sd, void* h8, void* hs, void* prod, void* p8,
                                     void* ps, void* out, int M, int D, int I, float eps,
                                     void* stream) {
  if (D % 16 || I % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;

  RowQuantArgs rx = rowquant_args(x, D, h8, hs, M, D);
  rx.gamma = static_cast<const bf16*>(ln);
  rx.eps = eps;
  if ((err = launch_rowquant<bf16>(rx, 1, st))) return err;

  Gemm8Args g = gemm8_args(h8, D, wg, hs, sg, prod, M, I, D);
  g.b2 = static_cast<const signed char*>(wu);
  g.col_scale2 = static_cast<const bf16*>(su);
  if ((err = launch_gemm8<E8_SILU_MUL>(g, st))) return err;

  RowQuantArgs rp = rowquant_args(prod, I, p8, ps, M, I);
  if ((err = launch_rowquant<float>(rp, 1, st))) return err;

  Gemm8Args gd = gemm8_args(p8, I, wd, ps, sd, out, M, D, I);
  gd.resid = static_cast<const bf16*>(x);
  gd.ld_resid = D;
  return launch_gemm8<E8_RESID>(gd, st);
}
