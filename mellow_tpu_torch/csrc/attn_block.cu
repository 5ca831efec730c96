// The prefill attention half of a Llama layer for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_attn_block.py
// (fused_attn_block): RMSNorm; q/k/v projections rounded to bf16; RoPE;
// causal GQA attention with an fp32 softmax; o-projection; residual. It
// also returns the roped k and the v rows, which go straight into the KV
// cache slice (strided output rows, see gemm_bf16.cuh), or, in the TPU
// kernel's kv_quant mode (_emit_quantized_kv), are quantized per position
// over all KV*hd lanes into an int8 cache slice and its fp32 scales.
//
// Contract: x (B*S, D) bf16; ln (D); wq (D, H*hd), wk and wv (D, KV*hd),
// wo (H*hd, D); cos and sin (S, hd) bf16 rope tables; scratch q and o
// (B*S, H*hd); k_out and v_out hold row s of batch b at
// b * kv_bstride + s * KV*hd; out (B*S, D). hd is 64 (the RoPE epilogue
// pairs columns within one 64-wide GEMM tile) and S <= 1024. With k8 set
// (kv_quant), k_out and v_out are contiguous scratch (kv_bstride = S*KV*hd)
// and the int8 rows go to k8/v8 (batch stride kv8_bstride), their scales
// to ks/vs (batch stride sc_bstride).
//
// What bounds it: at the v0 prefill (B=1, S=389, D=576, H=9, KV=3, hd=64)
// the block does ~0.8 GFLOP of projections and ~0.2 GFLOP of attention
// against ~2.4 MB of weights and activations: compute-bound in principle
// (~1 us at the bf16 tensor-core peak), in practice bound by the latency
// of five small launches that each fill only part of the 132 SMs.
//
// What the design does about it, for now: a chain of launches on one
// stream, no intermediate leaves the card's L2 in practice, and every
// product runs on the tensor cores (wmma bf16, fp32 accumulation):
//   1. q = rope(bf16(rms_norm(x) @ wq))     gemm, RMS prologue, RoPE epilogue
//   2. k = rope(bf16(rms_norm(x) @ wk))     written into the cache slice
//   3. v = bf16(rms_norm(x) @ wv)           written into the cache slice
//   4. o = causal GQA(q, k, v)              attn_core.cuh
//   5. out = x + bf16(o @ wo)               gemm, residual epilogue
//   6. (kv_quant) k, v -> int8 rows + scales, one warp per row
//      (gemm_int8.cuh); the amax spans all KV heads of a position, so the
//      quantizer runs after the k/v products rather than in their 64-wide
//      tiles.
// Fusing the chain into fewer launches (and wgmma/TMA) is later work.

#include "attn_core.cuh"
#include "gemm_int8.cuh"

// Launches the chain on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_attn_block(const void* x, const void* ln, const void* wq, const void* wk,
                                 const void* wv, const void* wo, const void* cos, const void* sin,
                                 void* q_buf, void* k_out, void* v_out, long long kv_bstride,
                                 void* o_buf, void* out, void* k8, void* v8, long long kv8_bstride,
                                 void* ks, void* vs, long long sc_bstride, int B, int S, int D,
                                 int H, int KV, int hd, float eps, void* stream) {
  if (hd != 64 || (k8 != nullptr && kv_bstride != (long long)S * KV * hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  int err;

  GemmArgs g = gemm_args(x, D, wq, q_buf, M, H * hd, D);
  g.gamma = static_cast<const bf16*>(ln);
  g.eps = eps;
  g.cos = static_cast<const bf16*>(cos);
  g.sin = static_cast<const bf16*>(sin);
  g.seq = S;
  g.head_dim = hd;
  if ((err = launch_gemm<NORM_RMS, EPI_ROPE>(g, st))) return err;

  g.b = static_cast<const bf16*>(wk);
  g.N = KV * hd;
  g.ldc = KV * hd;
  g.out = static_cast<bf16*>(k_out);
  g.rows_per_batch = S;
  g.batch_stride = kv_bstride;
  if ((err = launch_gemm<NORM_RMS, EPI_ROPE>(g, st))) return err;

  g.b = static_cast<const bf16*>(wv);
  g.out = static_cast<bf16*>(v_out);
  if ((err = launch_gemm<NORM_RMS, EPI_STORE>(g, st))) return err;

  const bf16* qp = static_cast<const bf16*>(q_buf);
  const bf16* kp = static_cast<const bf16*>(k_out);
  const bf16* vp = static_cast<const bf16*>(v_out);
  bf16* op = static_cast<bf16*>(o_buf);
  if ((err = launch_causal_gqa<64>(qp, kp, vp, op, B, S, H, KV, (long long)S * H * hd, H * hd,
                                   kv_bstride, KV * hd, st)))
    return err;

  GemmArgs go = gemm_args(o_buf, H * hd, wo, out, M, D, H * hd);
  go.resid = static_cast<const bf16*>(x);
  go.ld_resid = D;
  if ((err = launch_gemm<NORM_NONE, EPI_RESID>(go, st))) return err;
  if (k8 == nullptr) return 0;
  return launch_kv_quant(k_out, v_out, k8, v8, kv8_bstride, ks, vs, sc_bstride, B, S, KV * hd, st);
}
