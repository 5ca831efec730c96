// The port's per-row int8 quantizer for Hopper (sm_90a): rowquant_kernel,
// per row of an fp32 or bf16 matrix, optionally after an RMSNorm
// (h = x * rsqrt(mean(x^2) + eps) * gamma in fp32, not rounded):
// sc = max(max|h|, 1e-8) * (1/127), q = clip(rint(h / sc), -127, 127), rint
// rounding half to even as the TPU kernels' round does. Its int8 rows and
// fp32 scales can land in strided slices (the int8 KV cache and its
// per-position scales). #4's kv_quant mode and #5 (o8, k/v) launch it; the
// int8 products are proj_mma_core.cuh's, whose fused quantizers
// (pj_quantize_rows, pj_quant) repeat its arithmetic bit for bit.

#pragma once

#include "bf16_util.cuh"

namespace {

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
