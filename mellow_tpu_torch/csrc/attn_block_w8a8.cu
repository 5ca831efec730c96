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
// cos and sin (S, hd) bf16; scratch q and o (B*S, H*hd) bf16, o8
// (B*S, H*hd) int8 and os (B*S) fp32; k_out and
// v_out hold row s of batch b at b * kv_bstride + s * KV*hd (the bf16 cache
// slice, or contiguous scratch when k8 is set); out (B*S, D). With k8 set,
// the int8 rows go to k8/v8 (batch stride kv8_bstride) and the scales to
// ks/vs (batch stride sc_bstride). hd is 64, 1 <= S <= FP_MAX_S, D a
// multiple of 16, kv_bstride a multiple of 8.
//
// What bounds it: at the v0 prefill (B=1, S=389, D=576, H=9, KV=3, hd=64)
// the block does ~0.7 G int8 operations of projections and ~0.2 GFLOP of
// bf16 attention against ~1.9 MB of int8 weights, activations and int8
// k/v: ~0.6 us at the card's peaks, far less than the launches' latency.
//
// What the design does about it: four launches (five with kv_quant), the
// projections on proj_mma_core.cuh's int8 path (mma.sync m16n8k32 with
// int32 sums, the scales folded in after them as the TPU kernel does), the
// attention on flash_prefill_core.cuh:
//   1. q, k, v from one grid over the column tiles of [wq | wk | wv]: each
//      block quantizes its rows (fp32 norm, then rowquant's arithmetic)
//      into an int8 panel in shared memory, so h8 never reaches device
//      memory; then rope(bf16(h8 @ w * hs * sw)) for q and k, a store for v;
//   2. o = causal GQA(q, k, v)                bf16, launched as in attn_block.cu
//   3. o8, os = rowquant(o)                   one warp per row (rowquant.cuh)
//   4. out = x + bf16(o8 @ wo * os * so): o8 goes into the panel by cp.async;
//   5. (kv_quant) k, v -> int8 rows + per-position scales.
// o's quantizer stays a launch of its own: in the o-projection's prologue
// (9 column tiles re-quantizing the same rows, with x staged in shared
// memory) it cost more than the launch (PERF.md section 6). The norm keeps
// rowquant's order and a max is order-free, so h8, o8 and their scales are
// the separate quantizers' bits, and k, v and out (exact int32 sums) those
// of the chain this replaced.

#include "rowquant.cuh"
#include "proj_mma_core.cuh"

// Launches the chain on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_attn_block_w8a8(
    const void* x, const void* ln, const void* wq, const void* sq, const void* wk, const void* sk,
    const void* wv, const void* sv, const void* wo, const void* so, const void* cos,
    const void* sin, void* q_buf, void* k_out, void* v_out, long long kv_bstride, void* o_buf,
    void* o8, void* os, void* out, void* k8, void* v8, long long kv8_bstride, void* ks, void* vs,
    long long sc_bstride,
    int B, int S, int D, int H, int KV, int hd, float eps, void* stream) {
  if (hd != PJ_BN || S < 1 || S > FP_MAX_S || KV < 1 || H % KV || D % 16 || kv_bstride % 8 ||
      (k8 != nullptr && kv_bstride != (long long)S * KV * hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  int err;

  ProjArgs p = {};
  p.a = static_cast<const bf16*>(x);
  p.gamma = static_cast<const bf16*>(ln);
  p.eps = eps;
  p.w[0] = wq;
  p.w[1] = wk;
  p.w[2] = wv;
  p.w_scale[0] = static_cast<const bf16*>(sq);
  p.w_scale[1] = static_cast<const bf16*>(sk);
  p.w_scale[2] = static_cast<const bf16*>(sv);
  p.heads_q = H;
  p.heads_kv = KV;
  p.cos = static_cast<const bf16*>(cos);
  p.sin = static_cast<const bf16*>(sin);
  p.seq = S;
  p.q = static_cast<bf16*>(q_buf);
  p.k = static_cast<bf16*>(k_out);
  p.v = static_cast<bf16*>(v_out);
  p.kv_bstride = kv_bstride;
  p.M = M;
  p.K = D;
  if ((err = launch_proj<true, true>(p, st))) return err;

  if ((err = launch_flash_prefill<1, 2>(p.q, p.k, p.v, static_cast<bf16*>(o_buf), B, S, H, KV,
                                        (long long)S * H * hd, H * hd, kv_bstride, KV * hd, st)))
    return err;

  RowQuantArgs ro = rowquant_args(o_buf, H * hd, o8, os, M, H * hd);
  if ((err = launch_rowquant<bf16>(ro, 1, st))) return err;

  ProjArgs po = {};
  po.a8 = static_cast<const signed char*>(o8);
  po.a_scale = static_cast<const float*>(os);
  po.w[0] = wo;
  po.w_scale[0] = static_cast<const bf16*>(so);
  po.out = static_cast<bf16*>(out);
  po.resid = static_cast<const bf16*>(x);
  po.N = D;
  po.seq = S;
  po.M = M;
  po.K = H * hd;
  if ((err = launch_proj<true, false>(po, st))) return err;
  if (k8 == nullptr) return 0;
  return launch_kv_quant(k_out, v_out, k8, v8, kv8_bstride, ks, vs, sc_bstride, B, S, KV * hd, st);
}
