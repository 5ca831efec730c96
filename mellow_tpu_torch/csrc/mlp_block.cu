// The prefill MLP half of a Llama layer for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_mlp_block.py
// (fused_mlp_block): RMSNorm; gate and up projections; silu(gate) in fp32
// rounded to bf16; up rounded to bf16; their product in bf16; the down
// projection; the residual.
//
// Contract: x (M, D) bf16 with M = B*S rows; ln (D); w_gate and w_up
// (D, I); w_down (I, D); scratch act (M, I); out (M, D). D and I are
// multiples of 8.
//
// What bounds it: at the v0 prefill (M=389, D=576, I=1536) the block is
// 1.03 GFLOP against 5.3 MB of weights (bf16), so ~1 us of tensor-core
// work at the card's peak and ~1.6 us of HBM reads: on paper bytes and
// operations are close, and launch latency and partial SM fill (7 row
// tiles) dominate at B=1.
//
// What the design does about it: two launches of the shared tiled GEMM
// (gemm_bf16.cuh), every product on the tensor cores with fp32
// accumulation:
//   1. act = bf16(bf16(silu(h @ w_gate)) * bf16(h @ w_up)), h = rms_norm(x):
//      one kernel computes both products on the same normalised A tile
//      (the norm is a prologue; h never reaches device memory);
//   2. out = x + bf16(act @ w_down).
// The (M, I) activation does go through device memory (1.2 MB at B=1,
// L2-resident); keeping it on chip means one persistent kernel, later work.

#include "gemm_bf16.cuh"

// Launches both products on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_mlp_block(const void* x, const void* ln, const void* w_gate,
                                const void* w_up, const void* w_down, void* act, void* out, int M,
                                int D, int I, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemmArgs g = gemm_args(x, D, w_gate, act, M, I, D);
  g.b2 = static_cast<const bf16*>(w_up);
  g.gamma = static_cast<const bf16*>(ln);
  g.eps = eps;
  int err = launch_gemm<NORM_RMS, EPI_SILU_MUL>(g, st);
  if (err) return err;
  GemmArgs gd = gemm_args(act, I, w_down, out, M, D, I);
  gd.resid = static_cast<const bf16*>(x);
  gd.ld_resid = D;
  return launch_gemm<NORM_NONE, EPI_RESID>(gd, st);
}
