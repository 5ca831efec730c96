// One Swin Transformer block for Hopper (sm_90a), bf16, eval.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_swin_block.py
// (swin_block_fused): LN1; qkv + bias; window MHA with the relative-position
// bias and the -100 SW-MSA mask; proj + bias; residual; LN2; fc1 + bias;
// tanh-GELU (the TPU kernel's approximation, not erf); fc2 + bias; residual.
// The cyclic rolls of shifted blocks stay outside, as there.
//
// Contract: x (B, R, R, C) bf16, already rolled; ln1/ln2 scale and bias
// (C); w_qkv (C, 3C) + b_qkv (3C); w_proj (C, C) + b_proj; w_fc1 (C, 4C) +
// b_fc1; w_fc2 (4C, C) + b_fc2; bias (H, 64, 64) fp32 relative-position
// bias per head; mask (nW, 64, 64) fp32 or null; scratch qkv (M, 3C),
// o (M, C), x1 (M, C), hid (M, 4C) with M = B*R*R; out (M, C). The window
// is 8 x 8 (N = 64 tokens); hd = C / H <= 64; C a multiple of 8; the LN
// launches' shared memory (dense_panel_smem_bytes(C, 1)) at most
// PJ_MAX_DSMEM.
//
// What bounds it: at stage 1 of v0 (B=1, R=64, C=96, H=4) the block moves
// ~6 MB (x, the qkv, hidden and output activations, weights) and does
// ~0.5 GFLOP; bf16 tensor cores would finish the operations in ~0.5 us,
// so it is bound by bytes (~2 us at 3.35 TB/s) and, at this size, by the
// latency of its five dependent launches; at stage 3 (M = 256 rows) by the
// chain of K steps of the narrowest products.
//
// What the design does about it: the four products are proj_mma_core.cuh's
// dense products (mma.sync in registers, the weights through the cp.async
// ring), the attention is window_mma_core.cuh's register-resident core,
// shared with TPU kernel #9:
//   1. qkv = bf16(LN1(x) @ w_qkv + b_qkv): a block's 64 rows normalised
//      once into a whole-row panel (LN1(x) never reaches device memory);
//      the 288 columns of v0's qkv end in a half tile, zero-filled;
//   2. o = window attention, one block per (window, head, batch row), the
//      window's rows read in place from the (B, R, R, 3C) qkv (no partition
//      copy); q = bf16(q * bf16(hd^-0.5)) in registers before Q K^T; s =
//      (q . k) + bias + mask in fp32; p = bf16(exp(s - max) / sum), the
//      softmax normalised BEFORE the PV product; o = bf16(p @ v);
//   3. x1 = bf16(x + bf16(o @ w_proj + b_proj)): the o rows stream through
//      the ring beside the weight's, the K tiles split over a cluster;
//   4. hid = bf16(gelu_tanh(bf16(LN2(x1) @ w_fc1 + b_fc1))), as 1;
//   5. out = bf16(x1 + bf16(hid @ w_fc2 + b_fc2)), as 3 (K = 4C: 1,536 at
//      stage 3).

#include "proj_mma_core.cuh"
#include "window_mma_core.cuh"

namespace {

__global__ void __launch_bounds__(128) swin_qkv_kernel(DenseArgs p) {
  pj_dense_panel_body<PJN_LN, PJE_BIAS>(p);
}

__global__ void __launch_bounds__(128) swin_fc1_kernel(DenseArgs p) {
  pj_dense_panel_body<PJN_LN, PJE_GELU>(p);
}

template <int KS>
__global__ void __launch_bounds__(128) swin_proj_kernel(DenseArgs p) {
  pj_dense_stream_body<KS>(p);
}

template <int KS>
__global__ void __launch_bounds__(128) swin_fc2_kernel(DenseArgs p) {
  pj_dense_stream_body<KS>(p);
}

template <int KS>
struct SwinProj {
  static constexpr auto value = &swin_proj_kernel<KS>;
};

template <int KS>
struct SwinFc2 {
  static constexpr auto value = &swin_fc2_kernel<KS>;
};

// At most 128 registers a thread, so that four blocks fit an SM (as #9's).
template <int HDP>
__global__ void __launch_bounds__(WM_THREADS, 4)
swin_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                 const float* __restrict__ mask, bf16* __restrict__ o, int R, int C, int hd,
                 float scale, bool vec) {
  __shared__ __align__(128) unsigned char smem[WindowMmaSmem<HDP>::BYTES];
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nWw = R / 8;
  const size_t row0 = ((size_t)b * R + (w / nWw) * 8) * R + (w % nWw) * 8;
  window_mma_core<HDP, true>(qkv, o, row0, R, h, C, hd, scale, bias + (size_t)h * WM_N * WM_N,
                             mask != nullptr ? mask + (size_t)w * WM_N * WM_N : nullptr, vec,
                             reinterpret_cast<bf16*>(smem));
}

}  // namespace

// Launches the five steps on `stream`; returns the first cudaError_t, 0 on
// success. `scale` is hd^-0.5 already rounded to bf16 by the caller. Does
// not synchronise.
extern "C" int mellow_swin_block(const void* x, const void* ln1_s, const void* ln1_b,
                                 const void* w_qkv, const void* b_qkv, const void* w_proj,
                                 const void* b_proj, const void* ln2_s, const void* ln2_b,
                                 const void* w_fc1, const void* b_fc1, const void* w_fc2,
                                 const void* b_fc2, const void* bias, const void* mask,
                                 void* qkv_buf, void* o_buf, void* x1_buf, void* hid_buf,
                                 void* out, int B, int R, int C, int H, float scale, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * R * R;
  const int hd = H > 0 ? C / H : 0;
  if (B < 1 || R < 8 || R % 8 != 0 || hd < 1 || hd > 64 || hd * H != C || C % 8 != 0 ||
      dense_panel_smem_bytes(C, 1) > (size_t)PJ_MAX_DSMEM)
    return (int)cudaErrorInvalidValue;
  int err;

  DenseArgs g = {};
  g.a = static_cast<const bf16*>(x);
  g.gamma = static_cast<const bf16*>(ln1_s);
  g.beta = static_cast<const bf16*>(ln1_b);
  g.eps = eps;
  g.w = static_cast<const bf16*>(w_qkv);
  g.bias = static_cast<const bf16*>(b_qkv);
  g.out = static_cast<bf16*>(qkv_buf);
  g.M = M;
  g.N = 3 * C;
  g.K = C;
  if ((err = launch_dense_panel<&swin_qkv_kernel>(g, 1, st))) return err;

  const dim3 grid((R / 8) * (R / 8), H, B);
  const bf16* qkv_in = static_cast<const bf16*>(qkv_buf);
  const float* bias_in = static_cast<const float*>(bias);
  const float* mask_in = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(o_buf);
  // 16-byte copies need 8-element head slices (C % 8 == 0 keeps the rows
  // aligned).
  const bool vec = hd % 8 == 0;
  if (hd <= 32)
    swin_attn_kernel<32><<<grid, WM_THREADS, 0, st>>>(qkv_in, bias_in, mask_in, o, R, C, hd, scale, vec);
  else
    swin_attn_kernel<64><<<grid, WM_THREADS, 0, st>>>(qkv_in, bias_in, mask_in, o, R, C, hd, scale, vec);
  if ((err = (int)cudaGetLastError())) return err;

  DenseArgs d = {};
  d.a = o;
  d.w = static_cast<const bf16*>(w_proj);
  d.bias = static_cast<const bf16*>(b_proj);
  d.resid = static_cast<const bf16*>(x);
  d.out = static_cast<bf16*>(x1_buf);
  d.M = M;
  d.N = C;
  d.K = C;
  if ((err = launch_dense_stream<SwinProj>(d, st))) return err;

  DenseArgs g1 = g;
  g1.a = static_cast<const bf16*>(x1_buf);
  g1.gamma = static_cast<const bf16*>(ln2_s);
  g1.beta = static_cast<const bf16*>(ln2_b);
  g1.w = static_cast<const bf16*>(w_fc1);
  g1.bias = static_cast<const bf16*>(b_fc1);
  g1.out = static_cast<bf16*>(hid_buf);
  g1.N = 4 * C;
  if ((err = launch_dense_panel<&swin_fc1_kernel>(g1, 1, st))) return err;

  d.a = static_cast<const bf16*>(hid_buf);
  d.w = static_cast<const bf16*>(w_fc2);
  d.bias = static_cast<const bf16*>(b_fc2);
  d.resid = static_cast<const bf16*>(x1_buf);
  d.out = static_cast<bf16*>(out);
  d.K = 4 * C;
  return launch_dense_stream<SwinFc2>(d, st);
}
