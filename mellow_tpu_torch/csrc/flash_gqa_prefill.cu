// Causal GQA prefill attention for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_attention.py
// (flash_gqa_prefill, its "square" _kernel), which the GPT-2 prefill runs in
// every layer in bf16: o = softmax(q k^T / sqrt(hd), causal) v per head,
// query head h reading KV group h / (H / KV), with the TPU kernel's rounding
// points (fp32 scores, -1e30 above the diagonal, exp rounded to bf16 before
// the PV product, fp32 sum of the unrounded exps). The function is the
// attention core of attn_core.cuh alone; this file launches it on its own.
//
// Contract: q (B, S, H*hd), k and v (B, S, KV*hd) bf16, each addressed by a
// batch stride and a row stride (elements), so that GPT-2's q, k and v can be
// the three column slices of one (B, S, 3*D) qkv product without copies;
// k and v share their strides. Bases and strides are multiples of 8
// elements. o is contiguous (B, S, H*hd). hd is 64 and 1 <= S <= 1024 (the
// block keeps its 32 rows of scores over all S keys in shared memory:
// 207 KB at S = 1024).
//
// What bounds it: at the GPT-2 prefill (B=1, S=389, H=KV=12, hd=64) the
// function reads q, k, v and writes o, 2.4 MB (0.7 us at 3.35 TB/s), and its
// causal triangle is 0.23 GFLOP (0.24 us at the bf16 tensor-core peak), so
// bytes bound it in principle; in practice one launch of 13 x 12 blocks,
// each a short loop of 64-key tiles, is bound by its own latency.
//
// What the design does about it, for now: every product on the tensor cores
// (wmma bf16, fp32 accumulation), the scores never leave shared memory, and
// no host-side copy or pad of q, k or v. wgmma/TMA, and skipping the masked
// upper triangle inside a key tile, are later work.

#include "attn_core.cuh"

// Launches the kernel on `stream`; returns the cudaError_t of the launch, 0 on
// success. Does not synchronise.
extern "C" int mellow_flash_gqa_prefill(const void* q, const void* k, const void* v, void* o,
                                        long long q_bstride, int ldq, long long kv_bstride,
                                        int ldkv, int B, int S, int H, int KV, int hd,
                                        void* stream) {
  if (hd != 64 || S < 1 || S > 1024 || KV < 1 || H % KV || ldq % 8 || ldkv % 8 ||
      q_bstride % 8 || kv_bstride % 8)
    return (int)cudaErrorInvalidValue;
  return launch_causal_gqa<64>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                               static_cast<const bf16*>(v), static_cast<bf16*>(o), B, S, H, KV,
                               q_bstride, ldq, kv_bstride, ldkv, static_cast<cudaStream_t>(stream));
}
