// Shared pieces of the port's int8 kernels for Hopper (sm_90a): a tiled
// int8 tensor-core GEMM with exact int32 sums and the scales folded in
// after the product, and a per-row int8 quantizer.
//
//   C[M, N] = A8[M, K] @ B8[K, N]   (A8, B8 row-major int8, int32 sums)
//   v = float(C) * row_scale[m] * col_scale[n]            (in that order)
//
// Epilogues (fp32 v -> output):
//   E8_STORE     out = bf16(v)
//   E8_ROPE      q = bf16(v); out = bf16(q * cos + rotate_half(q) * sin),
//                position = row % seq (HF half-split convention); needs
//                64 % head_dim == 0, so each head lies in one tile
//   E8_RESID     out = bf16(resid + bf16(v))
//   E8_SILU_MUL  two products (B8, B8_2, with their own column scales) on
//                the same A tile: out = silu(v) * v2, left in fp32
// The bf16 outputs land at out + (m / rows_per_batch) * batch_stride +
// (m % rows_per_batch) * ldc, so a product can go straight into a strided
// slice (a KV-cache layer).
//
// Row quantizer (rowquant_kernel): per row of an fp32 or bf16 matrix,
// optionally after an RMSNorm (h = x * rsqrt(mean(x^2) + eps) * gamma in
// fp32, not rounded): sc = max(max|h|, 1e-8) * (1/127), q = clip(rint(h /
// sc), -127, 127), rint rounding half to even as the TPU kernels' round
// does. Its int8 rows and fp32 scales can land in strided slices too (the
// int8 KV cache and its per-position scales).
//
// Design: 64 x 64 output tile per block of 4 warps, each warp a 32 x 32
// tile of 2 x 2 wmma m16n16k16 int8 fragments with int32 accumulators; K
// advances 64 at a time. Tiles are staged in shared memory as 16-byte-wide
// slabs (A: one slab per 16 columns of K, B: one per 16 columns of N), so
// every fragment starts 32-byte aligned. Loads are 16-byte vectors with
// zero fill past M, N and K: K, N and the row strides must be multiples of
// 16 (the wrappers check). No cp.async, wgmma or TMA yet.

#pragma once

#include <mma.h>

#include "bf16_util.cuh"

namespace {

namespace wmma = nvcuda::wmma;

enum Epi8Kind { E8_STORE = 0, E8_ROPE = 1, E8_RESID = 2, E8_SILU_MUL = 3 };

struct Gemm8Args {
  const signed char* a;  // (M, K), row stride lda
  int lda;
  const signed char* b;   // (K, N), row stride N
  const signed char* b2;  // second (K, N) weight, E8_SILU_MUL only
  const float* row_scale;  // (M)
  const bf16* col_scale;   // (N)
  const bf16* col_scale2;  // (N), E8_SILU_MUL only
  const bf16* resid;  // (M, N), row stride ld_resid, E8_RESID only
  int ld_resid;
  const bf16* cos;  // (seq, head_dim) tables, E8_ROPE only
  const bf16* sin;
  int seq;
  int head_dim;
  void* out;  // bf16, or fp32 for E8_SILU_MUL
  int ldc;
  int rows_per_batch;
  long long batch_stride;
  int M, N, K;
};

constexpr int QBM = 64, QBN = 64, QBK = 64, QTHREADS = 128;
constexpr int QSLAB = 16;      // bytes per slab row
constexpr int QC_LD = QBN + 4;  // int32 / fp32 elements
constexpr int Q_AB_BYTES = QBM * QBK + 2 * QBK * QBN;
constexpr int Q_C_BYTES = 2 * QBM * QC_LD * 4;
constexpr int Q_SMEM = Q_AB_BYTES > Q_C_BYTES ? Q_AB_BYTES : Q_C_BYTES;

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <int EPI>
__global__ void __launch_bounds__(QTHREADS) gemm_int8_kernel(Gemm8Args p) {
  constexpr bool DUAL = EPI == E8_SILU_MUL;
  __shared__ __align__(128) unsigned char smem[Q_SMEM];
  signed char* As = reinterpret_cast<signed char*>(smem);  // [K slab][row][16]
  signed char* Bs = As + QBM * QBK;                         // [N slab][k][16]
  signed char* Bs2 = Bs + QBK * QBN;
  int* Cs = reinterpret_cast<int*>(smem);
  int* Cs2 = Cs + QBM * QC_LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * QBM;
  const int n0 = blockIdx.x * QBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc2[DUAL ? 2 : 1][DUAL ? 2 : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  if (DUAL) {
#pragma unroll
    for (int i = 0; i < (DUAL ? 2 : 1); ++i)
#pragma unroll
      for (int j = 0; j < (DUAL ? 2 : 1); ++j) wmma::fill_fragment(acc2[i][j], 0);
  }
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  for (int k0 = 0; k0 < p.K; k0 += QBK) {
    for (int v = tid; v < QBM * QBK / 16; v += QTHREADS) {
      const int r = v / (QBK / 16);
      const int s = v % (QBK / 16);
      const int gm = m0 + r;
      const int gk = k0 + s * 16;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (gm < p.M && gk < p.K) u = __ldg(reinterpret_cast<const uint4*>(p.a + (size_t)gm * p.lda + gk));
      *reinterpret_cast<uint4*>(As + (s * QBM + r) * QSLAB) = u;
    }
    for (int v = tid; v < QBK * QBN / 16; v += QTHREADS) {
      const int r = v / (QBN / 16);
      const int s = v % (QBN / 16);
      const int gk = k0 + r;
      const int gn = n0 + s * 16;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      uint4 u2 = make_uint4(0u, 0u, 0u, 0u);
      if (gk < p.K && gn < p.N) {
        u = __ldg(reinterpret_cast<const uint4*>(p.b + (size_t)gk * p.N + gn));
        if (DUAL) u2 = __ldg(reinterpret_cast<const uint4*>(p.b2 + (size_t)gk * p.N + gn));
      }
      *reinterpret_cast<uint4*>(Bs + (s * QBK + r) * QSLAB) = u;
      if (DUAL) *reinterpret_cast<uint4*>(Bs2 + (s * QBK + r) * QSLAB) = u2;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + ((kk / 16) * QBM + wm + i * 16) * QSLAB, QSLAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (((wn + j * 16) / 16) * QBK + kk) * QSLAB, QSLAB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      if (DUAL) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs2 + (((wn + j * 16) / 16) * QBK + kk) * QSLAB, QSLAB);
#pragma unroll
        for (int i = 0; i < (DUAL ? 2 : 1); ++i)
#pragma unroll
          for (int j = 0; j < (DUAL ? 2 : 1); ++j) wmma::mma_sync(acc2[i][j], fa[i], fb[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

  // Stage the int32 sums (the operand tiles are dead after the last sync).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * QC_LD + wn + j * 16, acc[i][j], QC_LD,
                              wmma::mem_row_major);
  if (DUAL) {
#pragma unroll
    for (int i = 0; i < (DUAL ? 2 : 1); ++i)
#pragma unroll
      for (int j = 0; j < (DUAL ? 2 : 1); ++j)
        wmma::store_matrix_sync(Cs2 + (wm + i * 16) * QC_LD + wn + j * 16, acc2[i][j], QC_LD,
                                wmma::mem_row_major);
  }
  __syncthreads();
  float* Cf = reinterpret_cast<float*>(Cs);
  if (EPI == E8_ROPE) {
    // q = bf16(float(acc) * row_scale * col_scale) for every column, in
    // place, before columns pair up.
    for (int e = tid; e < QBM * QBN; e += QTHREADS) {
      const int r = e / QBN;
      const int c = e % QBN;
      const int gm = m0 + r;
      const int gn = n0 + c;
      float v = 0.f;
      if (gm < p.M && gn < p.N)
        v = bf16_round(__fmul_rn(__fmul_rn((float)Cs[r * QC_LD + c], p.row_scale[gm]),
                                 bf2f(p.col_scale[gn])));
      Cf[r * QC_LD + c] = v;
    }
    __syncthreads();
  }

  for (int e = tid; e < QBM * QBN; e += QTHREADS) {
    const int r = e / QBN;
    const int c = e % QBN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= p.M || gn >= p.N) continue;
    if (EPI == E8_SILU_MUL) {
      const float rs = p.row_scale[gm];
      const float g = __fmul_rn(__fmul_rn((float)Cs[r * QC_LD + c], rs), bf2f(p.col_scale[gn]));
      const float u = __fmul_rn(__fmul_rn((float)Cs2[r * QC_LD + c], rs), bf2f(p.col_scale2[gn]));
      static_cast<float*>(p.out)[(size_t)gm * p.ldc + gn] = __fmul_rn(silu(g), u);
      continue;
    }
    float o;
    if (EPI == E8_ROPE) {
      // The tile starts on a head boundary (n0 % 64 == 0, 64 % hd == 0), so
      // column c's partner c +- hd/2 is in this tile.
      const int hd = p.head_dim;
      const int half = hd / 2;
      const int ch = c % hd;
      const float v = Cf[r * QC_LD + c];
      const float rot = ch < half ? -Cf[r * QC_LD + c + half] : Cf[r * QC_LD + c - half];
      const int pos = gm % p.seq;
      o = v * bf2f(p.cos[(size_t)pos * hd + ch]) + rot * bf2f(p.sin[(size_t)pos * hd + ch]);
    } else {
      const float v = __fmul_rn(__fmul_rn((float)Cs[r * QC_LD + c], p.row_scale[gm]),
                                bf2f(p.col_scale[gn]));
      o = EPI == E8_RESID ? bf2f(p.resid[(size_t)gm * p.ld_resid + gn]) + bf16_round(v) : v;
    }
    const size_t row = (size_t)(gm / p.rows_per_batch) * (size_t)p.batch_stride +
                       (size_t)(gm % p.rows_per_batch) * (size_t)p.ldc;
    static_cast<bf16*>(p.out)[row + gn] = __float2bfloat16(o);
  }
}

// A zero-initialised Gemm8Args for an (M, N, K) product with its scales
// whose output is a plain row-major (M, N) matrix.
inline Gemm8Args gemm8_args(const void* a, int lda, const void* b, const void* row_scale,
                            const void* col_scale, void* out, int M, int N, int K) {
  Gemm8Args g = {};
  g.a = static_cast<const signed char*>(a);
  g.lda = lda;
  g.b = static_cast<const signed char*>(b);
  g.row_scale = static_cast<const float*>(row_scale);
  g.col_scale = static_cast<const bf16*>(col_scale);
  g.out = out;
  g.ldc = N;
  g.rows_per_batch = M;
  g.batch_stride = 0;
  g.M = M;
  g.N = N;
  g.K = K;
  return g;
}

template <int EPI>
int launch_gemm8(const Gemm8Args& g, cudaStream_t stream) {
  const dim3 grid((g.N + QBN - 1) / QBN, (g.M + QBM - 1) / QBM);
  gemm_int8_kernel<EPI><<<grid, QTHREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row quantizer: up to two matrices per launch (blockIdx.y picks one), one
// warp per row. Input row m is at x + m * ldx; output row m at q +
// (m / rows_per_batch) * q_bstride + (m % rows_per_batch) * ldq and its scale
// at scale + (m / rows_per_batch) * sc_bstride + m % rows_per_batch.
// ---------------------------------------------------------------------------

struct RowQuantArgs {
  const void* x[2];
  signed char* q[2];
  float* scale[2];
  const bf16* gamma;  // RMSNorm weight (K), or null for no norm
  float eps;
  long long ldx;
  int ldq;
  int rows_per_batch;
  long long q_bstride;
  long long sc_bstride;
  int M, K;
};

constexpr int RQ_THREADS = 128;

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  return static_cast<float>(*p);
}
template <>
__device__ __forceinline__ float load_f<bf16>(const bf16* p) {
  return bf2f(*p);
}

template <typename T>
__global__ void __launch_bounds__(RQ_THREADS) rowquant_kernel(RowQuantArgs a) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (RQ_THREADS / 32) + threadIdx.x / 32;
  if (m >= a.M) return;
  const int which = blockIdx.y;
  const T* x = static_cast<const T*>(a.x[which]) + (size_t)m * a.ldx;
  float rs = 1.f;
  if (a.gamma != nullptr) {
    float ss = 0.f;
    for (int k = lane; k < a.K; k += 32) {
      const float v = load_f(x + k);
      ss += v * v;
    }
    rs = rsqrtf(__fdiv_rn(warp_sum(ss), (float)a.K) + a.eps);
  }
  float amax = 0.f;
  for (int k = lane; k < a.K; k += 32) {
    float h = load_f(x + k);
    if (a.gamma != nullptr) h = __fmul_rn(__fmul_rn(h, rs), bf2f(a.gamma[k]));
    amax = fmaxf(amax, fabsf(h));
  }
  const float sc = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), 1.f / 127.f);
  const int bi = m / a.rows_per_batch;
  const int ri = m % a.rows_per_batch;
  signed char* q = a.q[which] + (size_t)bi * a.q_bstride + (size_t)ri * a.ldq;
  for (int k = lane; k < a.K; k += 32) {
    float h = load_f(x + k);
    if (a.gamma != nullptr) h = __fmul_rn(__fmul_rn(h, rs), bf2f(a.gamma[k]));
    const float r = fminf(fmaxf(rintf(__fdiv_rn(h, sc)), -127.f), 127.f);
    q[k] = (signed char)(int)r;
  }
  if (lane == 0) a.scale[which][(size_t)bi * a.sc_bstride + ri] = sc;
}

// Quantize n_mats (1 or 2) row-major (M, K) matrices of type T into plain
// (M, K) int8 rows and (M,) scales, or, with rows_per_batch and strides
// set by the caller, into strided slices.
inline RowQuantArgs rowquant_args(const void* x, long long ldx, void* q, void* scale, int M, int K) {
  RowQuantArgs r = {};
  r.x[0] = x;
  r.q[0] = static_cast<signed char*>(q);
  r.scale[0] = static_cast<float*>(scale);
  r.ldx = ldx;
  r.ldq = K;
  r.rows_per_batch = M;
  r.M = M;
  r.K = K;
  return r;
}

template <typename T>
int launch_rowquant(const RowQuantArgs& r, int n_mats, cudaStream_t stream) {
  const dim3 grid((r.M + RQ_THREADS / 32 - 1) / (RQ_THREADS / 32), n_mats);
  rowquant_kernel<T><<<grid, RQ_THREADS, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

// A prefill block's k and v rows, each a contiguous (B*S, W) bf16 matrix
// (W = KV*hd), quantized per position over all W lanes into an int8 cache
// slice (row s of batch b at b * q_bstride + s * W) and its fp32 scales
// (at b * sc_bstride + s): the TPU kernels' _emit_quantized_kv, k and v in
// one launch.
inline int launch_kv_quant(const void* k, const void* v, void* k8, void* v8, long long q_bstride,
                           void* ks, void* vs, long long sc_bstride, int B, int S, int W,
                           cudaStream_t stream) {
  RowQuantArgs r = rowquant_args(k, W, k8, ks, B * S, W);
  r.x[1] = v;
  r.q[1] = static_cast<signed char*>(v8);
  r.scale[1] = static_cast<float*>(vs);
  r.rows_per_batch = S;
  r.q_bstride = q_bstride;
  r.sc_bstride = sc_bstride;
  return launch_rowquant<bf16>(r, 2, stream);
}

}  // namespace
