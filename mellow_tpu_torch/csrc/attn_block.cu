// The prefill attention half of a Llama layer for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_attn_block.py
// (fused_attn_block): RMSNorm; q/k/v projections rounded to bf16; RoPE;
// causal GQA attention with an fp32 softmax; o-projection; residual. It
// also returns the roped k and the v rows, which go straight into the KV
// cache slice (strided output rows), or, in the TPU kernel's kv_quant mode
// (_emit_quantized_kv), are quantized per position over all KV*hd lanes
// into an int8 cache slice and its fp32 scales.
//
// Contract: x (B*S, D) bf16; ln (D); wq (D, H*hd), wk and wv (D, KV*hd),
// wo (H*hd, D); cos and sin (S, hd) bf16 rope tables; scratch q and o
// (B*S, H*hd); k_out and v_out hold row s of batch b at
// b * kv_bstride + s * KV*hd; out (B*S, D). hd is 64 (a projection column
// tile is one head), 1 <= S <= FP_MAX_S, D a multiple of 8, kv_bstride a
// multiple of 8. With k8 set (kv_quant), k_out and v_out are contiguous
// scratch (kv_bstride = S*KV*hd) and the int8 rows go to k8/v8 (batch
// stride kv8_bstride), their scales to ks/vs (batch stride sc_bstride).
//
// What bounds it: at the v0 prefill (B=1, S=389, D=576, H=9, KV=3, hd=64)
// the block does ~0.8 GFLOP of projections and ~0.2 GFLOP of attention
// against ~2.4 MB of weights and activations: ~1 us at the bf16
// tensor-core peak. In practice the launches' own latency bounds it.
//
// What the design does about it: three launches (four with kv_quant) on
// one stream, every product in registers on the tensor cores (mma.sync,
// fp32 accumulation), every operand through a cp.async ring:
//   1. q, k, v = rope/store(bf16(rms_norm(x) @ [wq | wk | wv]))
//      one grid over the 64-column tiles of the three weights
//      (proj_mma_core.cuh): each block normalises its rows once into a
//      shared-memory panel, runs the product and picks its epilogue by
//      tile (RoPE in registers into the q scratch or the k rows, a store
//      into the v rows);
//   2. o = causal GQA(q, k, v)               flash_prefill_core.cuh, one
//      query head a block, its key tiles split over two warpgroups
//      (launch_flash_prefill<1, 2>), whatever H / KV is. #10's rule
//      (flash_prefill_heads_per_block: three heads sharing each K/V tile
//      at v0's H / KV = 3, 21 blocks on 132 SMs at B=1 against 63) read
//      slower in device time of the whole chain at v0 (S=389) on an NVIDIA
//      H100 80GB HBM3 at 700 W: #4 0.0567 ms against 0.0461 at B=1 and
//      0.0825 against 0.0806 at B=4; #5 0.0736 against 0.0630 and 0.1066
//      against 0.1049;
//   3. out = x + bf16(o @ wo)                proj_mma_core.cuh
//   4. (kv_quant) k, v -> int8 rows + scales, one warp per row
//      (rowquant.cuh); the amax spans all KV heads of a position, so the
//      quantizer runs after the k/v tiles rather than in them.

#include "rowquant.cuh"
#include "proj_mma_core.cuh"

// Launches the chain on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_attn_block(const void* x, const void* ln, const void* wq, const void* wk,
                                 const void* wv, const void* wo, const void* cos, const void* sin,
                                 void* q_buf, void* k_out, void* v_out, long long kv_bstride,
                                 void* o_buf, void* out, void* k8, void* v8, long long kv8_bstride,
                                 void* ks, void* vs, long long sc_bstride, int B, int S, int D,
                                 int H, int KV, int hd, float eps, void* stream) {
  if (hd != PJ_BN || S < 1 || S > FP_MAX_S || KV < 1 || H % KV || D % 8 || kv_bstride % 8 ||
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
  if ((err = launch_proj<false, true>(p, st))) return err;

  if ((err = launch_flash_prefill<1, 2>(p.q, p.k, p.v, static_cast<bf16*>(o_buf), B, S, H, KV,
                                        (long long)S * H * hd, H * hd, kv_bstride, KV * hd, st)))
    return err;

  ProjArgs po = {};
  po.a = static_cast<const bf16*>(o_buf);
  po.w[0] = wo;
  po.out = static_cast<bf16*>(out);
  po.resid = static_cast<const bf16*>(x);
  po.N = D;
  po.seq = S;
  po.M = M;
  po.K = H * hd;
  if ((err = launch_proj<false, false>(po, st))) return err;
  if (k8 == nullptr) return 0;
  return launch_kv_quant(k_out, v_out, k8, v8, kv8_bstride, ks, vs, sc_bstride, B, S, KV * hd, st);
}
