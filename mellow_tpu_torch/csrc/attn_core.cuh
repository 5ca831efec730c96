// The causal GQA core: TPU kernel #10 (pallas_attention.flash_gqa_prefill,
// whose _kernel is this core alone; flash_gqa_prefill.cu launches it on its
// own for the GPT-2 prefill) and the attention inside #4 and #5 (bf16,
// attn_block.cu; W8A8, attn_block_w8a8.cu), which keep the same bf16
// attention core (pallas_attn_block._attention).
//
// One block per (32 query rows, head, batch row).
// Scores for the block's rows against every key they can see are kept in
// shared memory (S <= 1024), so the softmax uses the row's true maximum and
// rounds exp(s - max) to bf16 before the PV product exactly where the TPU
// kernels do (pallas_attention._kernel, pallas_attn_block._attn_row_block):
// s = (q . k) * scale, masked to -1e30 above the diagonal; e = exp(s - m);
// o = bf16(e) @ v in fp32, divided by sum(e) taken in fp32. Key rows past S
// load as zeros.
//
// Strides: q row s of batch b starts at b * q_bstride + s * ldq, k and v
// rows at b * kv_bstride + s * ldkv (head h at column h * HD, group g at
// g * HD), so q, k and v may be column slices of one packed qkv product or
// rows of a KV-cache slice; every stride and base is a multiple of 8
// elements (16-byte loads). The output is contiguous (B, S, H * HD).

#pragma once

#include "gemm_bf16.cuh"

namespace {

constexpr int AQ = 32;   // query rows per block
constexpr int AK = 64;   // keys per tile
constexpr int ATHREADS = 128;

__host__ __device__ inline int attn_score_ld(int S, int hd) {
  const int cols = ((S + AK - 1) / AK) * AK;
  return (cols > hd ? cols : hd) + 4;
}

__host__ __device__ inline int attn_prob_ld(int S) { return ((S + AK - 1) / AK) * AK + 8; }

inline size_t attn_smem_bytes(int S, int hd) {
  const int q_ld = hd + 8;
  return (size_t)AQ * q_ld * 2 + (size_t)AK * q_ld * 2 + (size_t)AQ * attn_score_ld(S, hd) * 4 +
         (size_t)AQ * attn_prob_ld(S) * 2 + (size_t)AQ * 4;
}

template <int HD>
__global__ void __launch_bounds__(ATHREADS)
causal_gqa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KV,
                  long long q_bstride, int ldq, long long kv_bstride, int ldkv, float scale) {
  constexpr int Q_LD = HD + 8;
  constexpr int O_LD = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int S_LD = attn_score_ld(S, HD);
  const int P_LD = attn_prob_ld(S);
  bf16* Qs = reinterpret_cast<bf16*>(smem);              // AQ x Q_LD
  bf16* KVs = Qs + AQ * Q_LD;                            // AK x Q_LD, K then V tiles
  float* Ss = reinterpret_cast<float*>(KVs + AK * Q_LD); // AQ x S_LD scores, later O
  bf16* Ps = reinterpret_cast<bf16*>(Ss + AQ * S_LD);    // AQ x P_LD bf16(exp)
  float* denom = reinterpret_cast<float*>(Ps + AQ * P_LD);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * AQ;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ldo = H * HD;
  const bf16* qb = q + (size_t)b * q_bstride + h * HD;
  const bf16* kb = k + (size_t)b * kv_bstride + g * HD;
  const bf16* vb = v + (size_t)b * kv_bstride + g * HD;
  const int n_keys = min(S, q0 + AQ);
  const int n_tiles = (n_keys + AK - 1) / AK;

  for (int e = tid; e < AQ * HD / 8; e += ATHREADS) {
    const int r = e / (HD / 8);
    const int c = (e % (HD / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) u = ldg16(qb + (size_t)(q0 + r) * ldq + c);
    *reinterpret_cast<uint4*>(Qs + r * Q_LD + c) = u;
  }

  // Scores: warp w owns key columns [16 w, 16 w + 16) of each tile.
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    for (int e = tid; e < AK * HD / 8; e += ATHREADS) {
      const int r = e / (HD / 8);
      const int c = (e % (HD / 8)) * 8;
      const int key = t * AK + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) u = ldg16(kb + (size_t)key * ldkv + c);
      *reinterpret_cast<uint4*>(KVs + r * Q_LD + c) = u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < AQ / 16; ++i) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + i * 16 * Q_LD + kk, Q_LD);
        wmma::load_matrix_sync(fb, KVs + warp * 16 * Q_LD + kk, Q_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + i * 16 * S_LD + t * AK + warp * 16, acc, S_LD,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Causal softmax over each row's full score row (fp32), one warp per row.
  const int n_cols = n_tiles * AK;
  for (int r = warp; r < AQ; r += ATHREADS / 32) {
    const int qi = q0 + r;
    float* srow = Ss + r * S_LD;
    float m = -1e30f;
    for (int j = lane; j < n_cols; j += 32) {
      const float s = (j <= qi && j < S) ? srow[j] * scale : -1e30f;
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n_cols; j += 32) {
      const float e = expf(srow[j] - m);
      sum += e;
      Ps[r * P_LD + j] = __float2bfloat16(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) denom[r] = sum;
  }

  // O = bf16(exp) @ V, accumulated over the key tiles in registers.
  constexpr int FR = AQ / 16;
  constexpr int OF = FR * (HD / 16);
  constexpr int PER_WARP = (OF + 3) / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[PER_WARP];
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) wmma::fill_fragment(oacc[i], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    for (int e = tid; e < AK * HD / 8; e += ATHREADS) {
      const int r = e / (HD / 8);
      const int c = (e % (HD / 8)) * 8;
      const int key = t * AK + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) u = ldg16(vb + (size_t)key * ldkv + c);
      *reinterpret_cast<uint4*>(KVs + r * Q_LD + c) = u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int f = warp + 4 * i;
      if (f < OF) {
        const int fr = f % FR;
        const int fc = f / FR;
#pragma unroll
        for (int kk = 0; kk < AK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + fr * 16 * P_LD + t * AK + kk, P_LD);
          wmma::load_matrix_sync(fb, KVs + kk * Q_LD + fc * 16, Q_LD);
          wmma::mma_sync(oacc[i], fa, fb, oacc[i]);
        }
      }
    }
  }
  __syncthreads();
  float* Os = Ss;  // AQ x O_LD, the scores are dead
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int f = warp + 4 * i;
    if (f < OF)
      wmma::store_matrix_sync(Os + (f % FR) * 16 * O_LD + (f / FR) * 16, oacc[i], O_LD,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < AQ * HD; e += ATHREADS) {
    const int r = e / HD;
    const int c = e % HD;
    if (q0 + r < S)
      o[((size_t)b * S + q0 + r) * ldo + h * HD + c] = __float2bfloat16(Os[r * O_LD + c] / denom[r]);
  }
}

template <int HD>
int launch_causal_gqa(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S, int H,
                      int KV, long long q_bstride, int ldq, long long kv_bstride, int ldkv,
                      cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(S, HD);
  cudaError_t err = cudaFuncSetAttribute(causal_gqa_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + AQ - 1) / AQ, H, B);
  causal_gqa_kernel<HD><<<grid, ATHREADS, smem, stream>>>(q, k, v, o, S, H, KV, q_bstride, ldq,
                                                          kv_bstride, ldkv, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace
