// Shared pieces of the port's bf16 kernels for Hopper (sm_90a): a tiled
// bf16 tensor-core GEMM with fp32 accumulation, an optional row-norm
// prologue and fused epilogues, plus small bf16 helpers.
//
//   C[M, N] = prologue(A)[M, K] @ B[K, N]   (A, B row-major bf16)
//
// Prologue (on the A tile as it is staged into shared memory):
//   NORM_RMS  h = bf16(x * rsqrt(mean(x^2) + eps) * gamma)        (llama RMSNorm)
//   NORM_LN   h = bf16((x - mu) * rsqrt(var + eps) * gamma + beta) (LayerNorm)
// The row statistics are taken in fp32 over the whole row at block start,
// and the normalised value is rounded to bf16 before the product, which is
// where the TPU kernels round it.
//
// Epilogues (fp32 accumulator -> bf16 store):
//   EPI_STORE     out = bf16(acc + bias)
//   EPI_RESID     out = bf16(resid + bf16(acc + bias))
//   EPI_GELU      g = bf16(acc + bias); out = bf16(tanh-GELU(g))
//   EPI_SILU_MUL  two products (B, B2) on the same A tile:
//                 out = bf16(bf16(silu(acc)) * bf16(acc2))
//   EPI_ROPE      q = bf16(acc); out = bf16(q * cos + rotate_half(q) * sin),
//                 position = row % seq (HF half-split convention); needs
//                 64 % head_dim == 0, so each head lies in one tile
// The bias is optional (null pointer). The output row m is written at
// out + (m / rows_per_batch) * batch_stride + (m % rows_per_batch) * ldc, so
// a product can land in a strided slice (a KV-cache layer) directly.
//
// Design: 64 x 64 output tile per block of 4 warps, each warp a 32 x 32
// tile of 2 x 2 wmma 16x16x16 fragments; K advances 32 at a time. Loads are
// 16-byte vectors with zero fill past M, N and K, so ragged edges (389
// prefix rows, widths 96 and 288) need no host padding; K and N must be
// multiples of 8 and the pointers 16-byte aligned (the wrappers check).
// No cp.async, no wgmma, no TMA yet: a plain, correct tile loop. The
// epilogue stages the accumulators through shared memory (aliasing the
// operand tiles) so that element-wise epilogues, and RoPE's pairing of
// columns c and c + hd/2 inside one head, see whole tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum NormKind { NORM_NONE = 0, NORM_RMS = 1, NORM_LN = 2 };
enum EpiKind { EPI_STORE = 0, EPI_RESID = 1, EPI_GELU = 2, EPI_SILU_MUL = 3, EPI_ROPE = 4 };

struct GemmArgs {
  const bf16* a;  // (M, K), row stride lda
  int lda;
  const bf16* b;   // (K, N), row stride N
  const bf16* b2;  // second (K, N) weight, EPI_SILU_MUL only
  const bf16* bias;                 // (N) or null
  const bf16* gamma;                // norm scale (K)
  const bf16* beta;                 // LayerNorm shift (K)
  float eps;
  const bf16* resid;  // (M, N), row stride ld_resid, EPI_RESID only
  int ld_resid;
  const bf16* cos;  // (seq, head_dim) tables, EPI_ROPE only
  const bf16* sin;
  int seq;
  int head_dim;
  bf16* out;
  int ldc;
  int rows_per_batch;
  long long batch_stride;
  int M, N, K;
};

constexpr int GBM = 64, GBN = 64, GBK = 32, GTHREADS = 128;
constexpr int GA_LD = GBK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int GB_LD = GBN + 8;
constexpr int GC_LD = GBN + 4;  // fp32 elements
constexpr int G_AB_BYTES = (GBM * GA_LD + 2 * GBK * GB_LD) * 2;
constexpr int G_C_BYTES = 2 * GBM * GC_LD * 4;
constexpr int G_SMEM = G_AB_BYTES > G_C_BYTES ? G_AB_BYTES : G_C_BYTES;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int NORM, int EPI>
__global__ void __launch_bounds__(GTHREADS) gemm_bf16_kernel(GemmArgs p) {
  constexpr bool DUAL = EPI == EPI_SILU_MUL;
  __shared__ __align__(128) unsigned char smem[G_SMEM];
  __shared__ float row_mu[GBM];
  __shared__ float row_rs[GBM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GBM * GA_LD;
  bf16* Bs2 = Bs + GBK * GB_LD;
  float* Cs = reinterpret_cast<float*>(smem);
  float* Cs2 = Cs + GBM * GC_LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * GBM;
  const int n0 = blockIdx.x * GBN;

  if (NORM != NORM_NONE) {
    // Row statistics in fp32, one warp per row.
    for (int r = warp; r < GBM; r += GTHREADS / 32) {
      const int gm = m0 + r;
      float mu = 0.f, rs = 0.f;
      if (gm < p.M) {
        const bf16* row = p.a + (size_t)gm * p.lda;
        if (NORM == NORM_LN) {
          float s = 0.f;
          for (int k = lane * 8; k < p.K; k += 256) {
            float f[8];
            unpack8(ldg16(row + k), f);
#pragma unroll
            for (int j = 0; j < 8; ++j) s += f[j];
          }
          mu = warp_sum(s) / (float)p.K;
        }
        float ss = 0.f;
        for (int k = lane * 8; k < p.K; k += 256) {
          float f[8];
          unpack8(ldg16(row + k), f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = f[j] - mu;
            ss += d * d;
          }
        }
        rs = rsqrtf(warp_sum(ss) / (float)p.K + p.eps);
      }
      if (lane == 0) {
        row_mu[r] = mu;
        row_rs[r] = rs;
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[DUAL ? 2 : 1][DUAL ? 2 : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  if (DUAL) {
#pragma unroll
    for (int i = 0; i < (DUAL ? 2 : 1); ++i)
#pragma unroll
      for (int j = 0; j < (DUAL ? 2 : 1); ++j) wmma::fill_fragment(acc2[i][j], 0.f);
  }
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  for (int k0 = 0; k0 < p.K; k0 += GBK) {
    for (int v = tid; v < GBM * GBK / 8; v += GTHREADS) {
      const int r = v / (GBK / 8);
      const int c = (v % (GBK / 8)) * 8;
      const int gm = m0 + r;
      const int gk = k0 + c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (gm < p.M && gk < p.K) {
        u = ldg16(p.a + (size_t)gm * p.lda + gk);
        if (NORM != NORM_NONE) {
          float f[8], g[8], bt[8];
          unpack8(u, f);
          unpack8(ldg16(p.gamma + gk), g);
          if (NORM == NORM_LN) unpack8(ldg16(p.beta + gk), bt);
          const float mu = row_mu[r], rs = row_rs[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float h = (f[j] - mu) * rs * g[j];
            if (NORM == NORM_LN) h += bt[j];
            f[j] = h;
          }
          u = pack8(f);
        }
      }
      *reinterpret_cast<uint4*>(As + r * GA_LD + c) = u;
    }
    for (int v = tid; v < GBK * GBN / 8; v += GTHREADS) {
      const int r = v / (GBN / 8);
      const int c = (v % (GBN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      uint4 u2 = make_uint4(0u, 0u, 0u, 0u);
      if (gk < p.K && gn < p.N) {
        u = ldg16(p.b + (size_t)gk * p.N + gn);
        if (DUAL) u2 = ldg16(p.b2 + (size_t)gk * p.N + gn);
      }
      *reinterpret_cast<uint4*>(Bs + r * GB_LD + c) = u;
      if (DUAL) *reinterpret_cast<uint4*>(Bs2 + r * GB_LD + c) = u2;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * GA_LD + kk, GA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * GB_LD + wn + j * 16, GB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      if (DUAL) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs2 + kk * GB_LD + wn + j * 16, GB_LD);
#pragma unroll
        for (int i = 0; i < (DUAL ? 2 : 1); ++i)
#pragma unroll
          for (int j = 0; j < (DUAL ? 2 : 1); ++j) wmma::mma_sync(acc2[i][j], fa[i], fb[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

  // Stage the accumulators (the operand tiles are dead after the last sync).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * GC_LD + wn + j * 16, acc[i][j], GC_LD,
                              wmma::mem_row_major);
  if (DUAL) {
#pragma unroll
    for (int i = 0; i < (DUAL ? 2 : 1); ++i)
#pragma unroll
      for (int j = 0; j < (DUAL ? 2 : 1); ++j)
        wmma::store_matrix_sync(Cs2 + (wm + i * 16) * GC_LD + wn + j * 16, acc2[i][j], GC_LD,
                                wmma::mem_row_major);
  }
  __syncthreads();
  if (EPI == EPI_ROPE) {
    // q = bf16(h @ w) first, for every column, before columns pair up.
    for (int e = tid; e < GBM * GBN; e += GTHREADS) {
      float* c = Cs + (e / GBN) * GC_LD + e % GBN;
      *c = bf16_round(*c);
    }
    __syncthreads();
  }

  for (int e = tid; e < GBM * GBN; e += GTHREADS) {
    const int r = e / GBN;
    const int c = e % GBN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= p.M || gn >= p.N) continue;
    float v = Cs[r * GC_LD + c];
    float o;
    if (EPI == EPI_SILU_MUL) {
      const float g = bf16_round(v / (1.f + expf(-v)));
      const float u = bf16_round(Cs2[r * GC_LD + c]);
      o = g * u;
    } else if (EPI == EPI_ROPE) {
      // The tile starts on a head boundary (n0 % 64 == 0, 64 % hd == 0), so
      // column c's partner c +- hd/2 is in this tile.
      const int hd = p.head_dim;
      const int half = hd / 2;
      const int ch = c % hd;
      const float rot = ch < half ? -Cs[r * GC_LD + c + half] : Cs[r * GC_LD + c - half];
      const int pos = gm % p.seq;
      o = v * bf2f(p.cos[(size_t)pos * hd + ch]) + rot * bf2f(p.sin[(size_t)pos * hd + ch]);
    } else {
      if (p.bias != nullptr) v += bf2f(p.bias[gn]);
      if (EPI == EPI_STORE) {
        o = v;
      } else if (EPI == EPI_GELU) {
        const float g = bf16_round(v);
        o = 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
      } else {  // EPI_RESID
        o = bf2f(p.resid[(size_t)gm * p.ld_resid + gn]) + bf16_round(v);
      }
    }
    const size_t row = (size_t)(gm / p.rows_per_batch) * (size_t)p.batch_stride +
                       (size_t)(gm % p.rows_per_batch) * (size_t)p.ldc;
    p.out[row + gn] = __float2bfloat16(o);
  }
}

// A zero-initialised GemmArgs for an (M, N, K) product whose output is a
// plain row-major (M, N) matrix.
inline GemmArgs gemm_args(const void* a, int lda, const void* b, void* out, int M, int N, int K) {
  GemmArgs g = {};
  g.a = static_cast<const bf16*>(a);
  g.lda = lda;
  g.b = static_cast<const bf16*>(b);
  g.out = static_cast<bf16*>(out);
  g.ldc = N;
  g.rows_per_batch = M;
  g.batch_stride = 0;
  g.M = M;
  g.N = N;
  g.K = K;
  return g;
}

template <int NORM, int EPI>
int launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((g.N + GBN - 1) / GBN, (g.M + GBM - 1) / GBM);
  gemm_bf16_kernel<NORM, EPI><<<grid, GTHREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
