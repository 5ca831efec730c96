// Causal GQA prefill attention for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_attention.py
// (flash_gqa_prefill, its "square" _kernel), which the GPT-2 prefill runs in
// every layer in bf16: o = softmax(q k^T / sqrt(hd), causal) v per head,
// query head h reading KV group h / (H / KV), with the TPU kernel's rounding
// points (fp32 scores, -1e30 above the diagonal, exp(s - max) with the
// row's true max rounded to bf16 before the PV product, fp32 sum of the
// unrounded exps). The kernel is flash_prefill_core.cuh alone; this file
// launches it on its own.
//
// Contract: q (B, S, H*hd), k and v (B, S, KV*hd) bf16, each addressed by a
// batch stride and a row stride (elements), so that GPT-2's q, k and v can be
// the three column slices of one (B, S, 3*D) qkv product without copies;
// k and v share their strides. Bases and strides are multiples of 8
// elements. o is contiguous (B, S, H*hd). hd is 64 and 1 <= S <= 8192
// (shared memory no longer grows with S; 8192 bounds what the wrapper
// offers); one launch per call.
//
// What bounds it: at the GPT-2 prefill (B=1, S=389, H=KV=12, hd=64) the
// function reads q, k, v and writes o, 2.4 MB (0.7 us at 3.35 TB/s), and its
// causal triangle is 0.23 GFLOP (0.24 us at the bf16 tensor-core peak), so
// bytes bound it in principle; in practice one launch of 7 x 12 blocks, each
// a loop over at most 7 key tiles twice, is bound by its own latency.
//
// What the design does about it (flash_prefill_core.cuh): the scores and the
// probabilities stay in registers (mma.sync m16n8k16 in the FlashAttention-2
// layout) instead of shared memory, so a block's shared memory (54 or 72 KB)
// does not grow with S; K/V tiles stream through a cp.async ring, so loads
// overlap the products; tiles above the diagonal are skipped, the heaviest
// query tiles launch first, one head's key tiles split over two warpgroups,
// and the query heads of a KV group share a block's tiles. mma.sync rather
// than wgmma: the score accumulator becomes the PV product's A operand in
// registers with no shared-memory operand in between, the kernel is short
// enough per block that latency, not the tensor-core rate, bounds it.

#include "flash_prefill_core.cuh"

// Launches the kernel on `stream`; returns the cudaError_t of the launch, 0 on
// success. Does not synchronise.
extern "C" int mellow_flash_gqa_prefill(const void* q, const void* k, const void* v, void* o,
                                        long long q_bstride, int ldq, long long kv_bstride,
                                        int ldkv, int B, int S, int H, int KV, int hd,
                                        void* stream) {
  if (hd != FP_HD || S < 1 || S > FP_MAX_S || KV < 1 || H % KV || ldq % 8 || ldkv % 8 ||
      q_bstride % 8 || kv_bstride % 8)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One query head a block (H = KV, or an odd group) splits the key tiles
  // over two warp sets; two to four heads share the tiles whole.
  switch (flash_prefill_heads_per_block(H / KV)) {
    case 4:
      return launch_flash_prefill<4, 1>(qp, kp, vp, op, B, S, H, KV, q_bstride, ldq, kv_bstride, ldkv, st);
    case 3:
      return launch_flash_prefill<3, 1>(qp, kp, vp, op, B, S, H, KV, q_bstride, ldq, kv_bstride, ldkv, st);
    case 2:
      return launch_flash_prefill<2, 1>(qp, kp, vp, op, B, S, H, KV, q_bstride, ldq, kv_bstride, ldkv, st);
    default:
      return launch_flash_prefill<1, 2>(qp, kp, vp, op, B, S, H, KV, q_bstride, ldq, kv_bstride, ldkv, st);
  }
}

