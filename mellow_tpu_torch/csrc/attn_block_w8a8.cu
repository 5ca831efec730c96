// The W8A8 prefill attention half of a Llama layer for Hopper (sm_90a).
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_attn_block.py
// (fused_attn_block_w8a8, body _kernel_w8a8): fp32 RMSNorm, not rounded,
// then per-row int8 activations (_rowquant); int8 x int8 q/k/v projections
// with int32 sums, times the row scale and the weights' per-column scale,
// rounded to bf16; RoPE; the bf16 causal GQA core of the bf16 block; per-row
// int8 of the attention output; the int8 o-projection; the residual. In the
// TPU kernel's kv_quant mode the roped k and the v rows are quantized per
// position over all KV*hd lanes into an int8 cache slice and its scales.
//
// Contract: x (B*S, D) bf16; ln (D) bf16; wq (D, H*hd), wk and wv
// (D, KV*hd), wo (H*hd, D) int8 with per-column bf16 scales sq, sk, sv, so;
// cos and sin (S, hd) bf16; scratch h8 (B*S, D) int8, hs (B*S) fp32, q and
// o (B*S, H*hd) bf16, o8 (B*S, H*hd) int8, os (B*S) fp32; k_out and v_out
// hold row s of batch b at b * kv_bstride + s * KV*hd (the bf16 cache slice,
// or contiguous scratch when k8 is set); out (B*S, D). With k8 set, the
// int8 rows go to k8/v8 (batch stride kv8_bstride) and the scales to ks/vs
// (batch stride sc_bstride). hd is 64, S <= 1024, and D, H*hd and KV*hd are
// multiples of 16.
//
// What bounds it: at the v0 prefill (B=1, S=389, D=576, H=9, KV=3, hd=64)
// the block does ~0.7 G int8 operations of projections and ~0.2 GFLOP of
// bf16 attention against ~1.9 MB of int8 weights, activations and int8
// k/v: ~0.6 us at the card's peaks, far less than the chain's launch
// latency at B=1.
//
// What the design does about it, for now: a chain of launches on one
// stream, every product on the tensor cores (wmma int8 with int32 sums for
// the projections, gemm_int8.cuh; wmma bf16 for the attention core,
// attn_core.cuh), the scales folded in after the integer sums as the TPU
// kernel does:
//   1. h8, hs = rowquant(rms_norm(x))       one warp per row, fp32 norm
//   2. q = rope(bf16(h8 @ wq * hs * sq))    int8 gemm, RoPE epilogue
//   3. k = rope(bf16(h8 @ wk * hs * sk))    into the cache slice or scratch
//   4. v = bf16(h8 @ wv * hs * sv)
//   5. o = causal GQA(q, k, v)              bf16
//   6. o8, os = rowquant(o)
//   7. out = x + bf16(o8 @ wo * os * so)    int8 gemm, residual epilogue
//   8. (kv_quant) k, v -> int8 rows + per-position scales
// Every quantizer needs a whole row's max before its product can start, so
// the row passes are launches of their own; fusing the chain is later work.

#include "attn_core.cuh"
#include "gemm_int8.cuh"

// Launches the chain on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_attn_block_w8a8(
    const void* x, const void* ln, const void* wq, const void* sq, const void* wk, const void* sk,
    const void* wv, const void* sv, const void* wo, const void* so, const void* cos,
    const void* sin, void* h8, void* hs, void* q_buf, void* k_out, void* v_out,
    long long kv_bstride, void* o_buf, void* o8, void* os, void* out, void* k8, void* v8,
    long long kv8_bstride, void* ks, void* vs, long long sc_bstride, int B, int S, int D, int H,
    int KV, int hd, float eps, void* stream) {
  if (hd != 64 || D % 16 || (k8 != nullptr && kv_bstride != (long long)S * KV * hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  int err;

  RowQuantArgs rx = rowquant_args(x, D, h8, hs, M, D);
  rx.gamma = static_cast<const bf16*>(ln);
  rx.eps = eps;
  if ((err = launch_rowquant<bf16>(rx, 1, st))) return err;

  Gemm8Args g = gemm8_args(h8, D, wq, hs, sq, q_buf, M, H * hd, D);
  g.cos = static_cast<const bf16*>(cos);
  g.sin = static_cast<const bf16*>(sin);
  g.seq = S;
  g.head_dim = hd;
  if ((err = launch_gemm8<E8_ROPE>(g, st))) return err;

  g.b = static_cast<const signed char*>(wk);
  g.col_scale = static_cast<const bf16*>(sk);
  g.N = KV * hd;
  g.ldc = KV * hd;
  g.out = k_out;
  g.rows_per_batch = S;
  g.batch_stride = kv_bstride;
  if ((err = launch_gemm8<E8_ROPE>(g, st))) return err;

  g.b = static_cast<const signed char*>(wv);
  g.col_scale = static_cast<const bf16*>(sv);
  g.out = v_out;
  if ((err = launch_gemm8<E8_STORE>(g, st))) return err;

  const bf16* qp = static_cast<const bf16*>(q_buf);
  const bf16* kp = static_cast<const bf16*>(k_out);
  const bf16* vp = static_cast<const bf16*>(v_out);
  if ((err = launch_causal_gqa<64>(qp, kp, vp, static_cast<bf16*>(o_buf), B, S, H, KV,
                                   (long long)S * H * hd, H * hd, kv_bstride, KV * hd, st)))
    return err;

  RowQuantArgs ro = rowquant_args(o_buf, H * hd, o8, os, M, H * hd);
  if ((err = launch_rowquant<bf16>(ro, 1, st))) return err;

  Gemm8Args go = gemm8_args(o8, H * hd, wo, os, so, out, M, D, H * hd);
  go.resid = static_cast<const bf16*>(x);
  go.ld_resid = D;
  if ((err = launch_gemm8<E8_RESID>(go, st))) return err;
  if (k8 == nullptr) return 0;
  return launch_kv_quant(k_out, v_out, k8, v8, kv8_bstride, ks, vs, sc_bstride, B, S, KV * hd, st);
}
