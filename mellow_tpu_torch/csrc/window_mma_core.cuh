// The register-resident Swin window-attention core of TPU kernel #9
// (pallas_window_attention.window_attention_fused) and of the attention
// inside TPU kernel #8 (pallas_swin_block.swin_block_fused) for Hopper
// (sm_90a).
//
// One block of four warps per (window, head); warp w owns query rows
// [16 w, 16 w + 16) of the 8 x 8 window. The function, with the TPU kernels'
// rounding points; where the scale applies is SCALE_Q:
//   false (#9): s = (Q K^T) * scale in fp32 (the exact bf16 products summed
//       in fp32, then times the fp32 hd^-0.5: q is never rounded after the
//       scale; JAX promotes bf16 q times an np.float32 scale to fp32);
//   true (#8): q = bf16(q * scale), scale = bf16(hd^-0.5), on the Q
//       fragments in registers, then s = Q K^T in fp32 (pallas_swin_block
//       rounds q to the compute dtype);
//   s = s + bias + mask, each add rounded in fp32,
//   p = bf16(exp(s - max) / sum), normalised before PV (0 where
//       exp(s - max) < 2^-100: see wm_prob),
//   o = bf16(p @ v), accumulated in fp32.
//
// The chain of dependent memory round trips is one round long:
//   * every load is issued at once: the (window, head) slices of q, k and v
//     as 16-byte cp.async copies into shared memory (64 rows of hd columns
//     each, zero-padded to HDP = 32 or 64), and the bias and mask values of
//     the thread's score fragment as float2 pairs into registers; then one
//     wait and one block barrier. No global load remains after it;
//   * the products are mma.sync.m16n8k16 bf16 with fp32 accumulators in the
//     FlashAttention-2 register layout (flash_prefill_core.cuh's fp_*
//     helpers): Q and K fragments by ldmatrix, the warp's 16 x 64 scores in
//     registers, the row max and sum by quad shuffles, p packed straight
//     into the A fragments of PV, V fragments by ldmatrix.trans;
//   * the epilogue rounds to bf16, stages the warp's 16 rows in its own
//     (already read) Q rows and writes them with 16-byte stores.
// A head width that is not a multiple of 8 (no 16-byte copies) falls back
// to element copies into the same layout.
//
// Token n (row-major in the 8 x 8 window) is row row0 + (n / 8) * row_step +
// n % 8 of qkv (row length 3C: q | k | v, head h at column h * hd of each)
// and of the output (row length C): row_step 8 for #9's packed (Bn, 64, 3C)
// windows (row0 = w * 64), R for a window read in place from #8's
// (B, R, R, 3C) grid.

#pragma once

#include "flash_prefill_core.cuh"

namespace {

constexpr int WM_N = 64;         // tokens per 8 x 8 window
constexpr int WM_THREADS = 128;  // four warps, 16 query rows each

// p = e / sum rounded to nearest, or 0 where e < 2^-100. The
// shifted-window mask's -100 puts exp(s - max) near e^-100, a subnormal,
// and fp32 division takes its slow path on a subnormal or zero numerator
// (~9 us a launch at HTSAT-large stage 2, B=1); a numerator clamped to 2^-100
// keeps every division on the fast path (sum is in [1, 64]), and p < 2^-100
// adds less than 2^-94 max|v| to an output.
__device__ __forceinline__ float wm_prob(float e, float sum) {
  const bool keep = e >= 0x1p-100f;
  const float q = __fdiv_rn(keep ? e : 0x1p-100f, sum);
  return keep ? q : 0.f;
}

template <int HDP>
struct WindowMmaSmem {
  static_assert(HDP == 32 || HDP == 64, "head dim padded to 32 or 64");
  // Row stride of 80 or 144 bytes: the eight rows of an ldmatrix fall on
  // distinct banks.
  static constexpr int LD = HDP + 8;
  static constexpr int TILE = WM_N * LD;  // elements of one of Q, K, V
  static constexpr int BYTES = 3 * TILE * 2;
  static_assert(BYTES <= 48 * 1024, "static shared memory");
};

// Row of token n (row-major in the 8 x 8 window) in the qkv and output
// matrices, counted from the window's first row: (n / 8) * row_step + n % 8.
__device__ __forceinline__ int wm_row(int row_step, int n) { return (n >> 3) * row_step + (n & 7); }

// q * scale rounded to bf16, for the two bf16 values of one fragment
// register.
__device__ __forceinline__ uint32_t wm_scale2(uint32_t q2, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q2));
  return fp_pack(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
}

template <int HDP, bool SCALE_Q>
__device__ __forceinline__ void window_mma_core(const bf16* __restrict__ qkv,
                                                bf16* __restrict__ o, size_t row0, int row_step,
                                                int h, int C, int hd, float scale,
                                                const float* __restrict__ bias_h,
                                                const float* __restrict__ mask_w, bool vec,
                                                bf16* smem) {
  using L = WindowMmaSmem<HDP>;
  bf16* Qs = smem;
  bf16* Ks = Qs + L::TILE;
  bf16* Vs = Ks + L::TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2;  // fragment rows gid and gid + 8
  const int tig = lane & 3;   // fragment column pair
  const bf16* src = qkv + row0 * 3 * C + (size_t)h * hd;

  // 1. Every load at once. q, k, v: 8-element chunks of each row (chunks
  // past hd are zero-filled, nothing read).
  if (vec) {
    constexpr int CH = HDP / 8;
    for (int e = tid; e < 3 * WM_N * CH; e += WM_THREADS) {
      const int which = e / (WM_N * CH);
      const int n = (e / CH) % WM_N;
      const int c = (e % CH) * 8;
      const bool valid = c < hd;
      fp_cp_async16(smem + which * L::TILE + n * L::LD + c,
                    src + (size_t)wm_row(row_step, n) * 3 * C + which * C + (valid ? c : 0), valid);
    }
    fp_cp_async_commit();
  } else {
    for (int e = tid; e < 3 * WM_N * HDP; e += WM_THREADS) {
      const int which = e / (WM_N * HDP);
      const int n = (e / HDP) % WM_N;
      const int d = e % HDP;
      smem[which * L::TILE + n * L::LD + d] =
          d < hd ? src[(size_t)wm_row(row_step, n) * 3 * C + which * C + d] : __float2bfloat16(0.f);
    }
  }
  // The bias and mask at this thread's score fragment: rows r0, r0 + 8,
  // columns 8 j + 2 tig + {0, 1}.
  const int r0 = warp * 16 + gid;
  float2 bm[WM_N / 8][2], mm[WM_N / 8][2];
#pragma unroll
  for (int j = 0; j < WM_N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (r0 + 8 * i) * WM_N + 8 * j + 2 * tig;
      bm[j][i] = __ldg(reinterpret_cast<const float2*>(bias_h + at));
      mm[j][i] = mask_w != nullptr ? __ldg(reinterpret_cast<const float2*>(mask_w + at))
                                   : make_float2(0.f, 0.f);
    }
  if (vec) fp_cp_async_wait<0>();
  __syncthreads();

  // 2. S = Q K^T for the warp's 16 rows, all eight 8-key blocks' chains
  // issued together.
  float s[WM_N / 8][4];
#pragma unroll
  for (int j = 0; j < WM_N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; kk += 2) {
    // Q rows 16 w.., dims 16 kk + {0, 8} (A of step kk) and 16 kk + {16, 24}
    // (A of step kk + 1).
    uint32_t qa[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int m = lane >> 3;
      fp_ldmatrix_x4(qa[t], Qs + (warp * 16 + (lane & 7) + 8 * (m & 1)) * L::LD + 16 * (kk + t) +
                                8 * (m >> 1));
      if (SCALE_Q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[t][i] = wm_scale2(qa[t][i], scale);
      }
    }
    uint32_t kf[WM_N / 8][4];  // K rows 8 j.., dims 16 kk + {0, 8, 16, 24}
#pragma unroll
    for (int j = 0; j < WM_N / 8; ++j)
      fp_ldmatrix_x4(kf[j], Ks + (8 * j + (lane & 7)) * L::LD + 16 * kk + 8 * (lane >> 3));
#pragma unroll
    for (int j = 0; j < WM_N / 8; ++j) fp_mma(s[j], qa[0], kf[j][0], kf[j][1]);
#pragma unroll
    for (int j = 0; j < WM_N / 8; ++j) fp_mma(s[j], qa[1], kf[j][2], kf[j][3]);
  }

  // 3. The fp32 softmax of rows r0 and r0 + 8, normalised, as bf16 A
  // fragments of PV (keys 16 kk..: blocks 2 kk and 2 kk + 1).
#pragma unroll
  for (int j = 0; j < WM_N / 8; ++j) {
    const float b[4] = {bm[j][0].x, bm[j][0].y, bm[j][1].x, bm[j][1].y};
    const float mk[4] = {mm[j][0].x, mm[j][0].y, mm[j][1].x, mm[j][1].y};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[j][i] = __fadd_rn(__fadd_rn(SCALE_Q ? s[j][i] : __fmul_rn(s[j][i], scale), b[i]), mk[i]);
  }
  float mx[2] = {s[0][0], s[0][2]};
#pragma unroll
  for (int j = 0; j < WM_N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < WM_N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - mx[i / 2]);
      sum[i / 2] += s[j][i];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  uint32_t pa[WM_N / 16][4];
#pragma unroll
  for (int j = 0; j < WM_N / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = fp_pack(wm_prob(s[j][0], sum[0]), wm_prob(s[j][1], sum[0]));
    pa[j / 2][(j % 2) * 2 + 1] = fp_pack(wm_prob(s[j][2], sum[1]), wm_prob(s[j][3], sum[1]));
  }

  // 4. O = P V: V keys 16 kk + {0, 8}, dims 16 jj + {0, 8}, transposed.
  float oacc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WM_N / 16; ++kk) {
    uint32_t vf[HDP / 16][4];
#pragma unroll
    for (int jj = 0; jj < HDP / 16; ++jj)
      fp_ldmatrix_x4_trans(vf[jj], Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::LD +
                                       16 * jj + 8 * (lane >> 4));
#pragma unroll
    for (int jj = 0; jj < HDP / 16; ++jj) {
      fp_mma(oacc[2 * jj], pa[kk], vf[jj][0], vf[jj][1]);
      fp_mma(oacc[2 * jj + 1], pa[kk], vf[jj][2], vf[jj][3]);
    }
  }

  // 5. bf16 rows staged in the warp's own Q rows (only this warp read them),
  // then 16-byte stores of the hd live columns.
  bf16* os = Qs + warp * 16 * L::LD;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    *reinterpret_cast<uint32_t*>(os + gid * L::LD + 8 * j + 2 * tig) =
        fp_pack(oacc[j][0], oacc[j][1]);
    *reinterpret_cast<uint32_t*>(os + (gid + 8) * L::LD + 8 * j + 2 * tig) =
        fp_pack(oacc[j][2], oacc[j][3]);
  }
  __syncwarp();
  bf16* dst = o + row0 * C + (size_t)h * hd;
  if (vec) {
    const int ch = hd / 8;
    for (int e = lane; e < 16 * ch; e += 32) {
      const int r = e / ch;
      const int c = (e % ch) * 8;
      *reinterpret_cast<uint4*>(dst + (size_t)wm_row(row_step, warp * 16 + r) * C + c) =
          *reinterpret_cast<const uint4*>(os + r * L::LD + c);
    }
  } else {
    for (int e = lane; e < 16 * hd; e += 32) {
      const int r = e / hd;
      const int c = e % hd;
      dst[(size_t)wm_row(row_step, warp * 16 + r) * C + c] = os[r * L::LD + c];
    }
  }
}

}  // namespace
