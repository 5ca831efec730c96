// Swin window attention (the core between the qkv and proj products) for
// Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_window_attention.py
// (window_attention_fused), which the JAX package runs for a bf16 Swin block
// that fails the whole-block gate of pallas_swin_block (10 MB) and passes
// its own per-window gate (6 MB): stage 2 of HTSAT-large (C = 512, H = 8,
// hd = 64). Per window and head: o = softmax(q k^T * hd^-0.5 + bias
// [+ mask]) v, with the TPU kernel's rounding points: q is not rounded
// before the scale (bf16 q times an np.float32 scale is fp32 in JAX), the
// scores, bias, mask and softmax are fp32, p = bf16(exp(s - max) / sum),
// p @ v sums in fp32 and the output is rounded to bf16 once.
//
// Contract: qkv (Bn, 64, 3C) bf16 contiguous, the qkv product of Bn packed
// 8 x 8 windows (q | k | v, head h at column h * hd of each); bias
// (H, 64, 64) fp32 relative-position bias; mask (n_mask, 64, 64) fp32 or
// null, window w taking mask[w % n_mask]; out (Bn, 64, C) bf16. hd = C / H
// <= 64. `scale` is fp32 hd^-0.5.
//
// What bounds it: at HTSAT-large stage 2 with B=1 (Bn = 16 windows, C =
// 512) it reads 3.1 MB of qkv and writes 1 MB (1.3 us at 3.35 TB/s) and
// does 0.13 GFLOP of QK^T and PV (0.14 us on the bf16 tensor cores), so
// bytes bound it; in practice one launch of 16 x 8 = 128 blocks on 132 SMs,
// each a single pass over one window, is bound by its latency.
//
// What the design does about it: window_mma_core.cuh, one block of four
// warps per (window, head) whose chain of dependent memory round trips is
// one round long: every load (q, k, v by 16-byte cp.async; the bias and mask
// of each thread's score fragment into registers) is issued at once before
// the block's one barrier, both products run on mma.sync with the scores and
// probabilities in registers, and the output leaves in 16-byte stores.
// #8 (swin_block.cu) runs the same core on windows read in place.

#include "window_mma_core.cuh"

namespace {

// At most 128 registers a thread, so that four blocks fit an SM and B=4's
// 512 blocks run in one wave.
template <int HDP>
__global__ void __launch_bounds__(WM_THREADS, 4)
window_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, int n_mask, bf16* __restrict__ o, int C,
                        int hd, float scale, bool vec) {
  __shared__ __align__(128) unsigned char smem[WindowMmaSmem<HDP>::BYTES];
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  window_mma_core<HDP, false>(qkv, o, (size_t)w * WM_N, 8, h, C, hd, scale, bias + (size_t)h * WM_N * WM_N,
                              mask != nullptr ? mask + (size_t)(w % n_mask) * WM_N * WM_N : nullptr, vec,
                              reinterpret_cast<bf16*>(smem));
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch, 0 on
// success. Does not synchronise.
extern "C" int mellow_window_attention(const void* qkv, const void* bias, const void* mask,
                                       void* out, int Bn, int C, int H, int n_mask, float scale,
                                       void* stream) {
  const int hd = H > 0 ? C / H : 0;
  if (Bn < 1 || H < 1 || hd < 1 || hd > 64 || hd * H != C || (mask != nullptr && n_mask < 1))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need 8-element head slices and 16-byte aligned rows.
  const bool vec = hd % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(Bn, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  if (hd <= 32)
    window_attention_kernel<32><<<grid, WM_THREADS, 0, st>>>(q, b, m, n_mask,
                                                             static_cast<bf16*>(out), C, hd, scale, vec);
  else
    window_attention_kernel<64><<<grid, WM_THREADS, 0, st>>>(q, b, m, n_mask,
                                                             static_cast<bf16*>(out), C, hd, scale, vec);
  return (int)cudaGetLastError();
}
