// Fused log-mel spectrogram for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_melspec.py
// (log_mel_spectrogram_pallas): reflect-pad, frame (n_fft 1024, hop 320),
// Hann-windowed DFT power over 513 bins, the 513 -> 64 mel projection,
// 10*log10(max(mel, amin)) - ref_db. The TPU kernel multiplies the frames
// by a dense (1024, 1026) DFT basis on its matrix unit; here each frame's
// spectrum comes from an FFT.
//
// Contract: wave (B, n_samples) fp32 contiguous on the device, n_samples >=
// 513 -> out (B, 1 + n_samples / 320, 64) fp32. The tables are
// frontend.fft_tables': window (1024) the periodic Hann window; twiddles
// (1024) complex W^k = exp(-2 pi i k / 1024), computed in float64 and
// rounded; bands (64, 2) each mel's first and last nonzero bin and
// band_w (64, band_stride) its filter weights over those bins.
//
// What bounds it: a 10 s clip is 1001 frames; their FFTs, power and mel
// projection are ~0.03 GFLOP against 1.3 MB of wave and 0.26 MB of output,
// so ~0.4 us at the card's fp32 or memory rate: the launch and one block's
// chain of dependent steps (a global load, three FFT passes, the post-pass,
// the mel sums) are what a call pays. Parity mode's tolerance leaves no room
// for TF32, so there are no tensor cores here.
//
// What the design does about it:
//  * one block per (clip, tile of MS_F = 4 frames), 64 threads a frame: 251
//    blocks per clip. The tile's frames overlap (hop 320 < n_fft 1024), so
//    the block stages the one stretch of the reflect-padded wave they cover
//    (1,984 samples) in shared memory; the reflection happens on that load;
//  * the 1024-point real FFT of a frame is a 512-point complex FFT of
//    z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] and a post-pass that splits it
//    into the real spectrum, X[k] = E[k] + W^k O[k] with
//    E = (Z[k] + conj Z[512-k]) / 2, O = (Z[k] - conj Z[512-k]) / 2i;
//  * the 512-point FFT is three Stockham radix-8 passes: each thread keeps
//    8 points in registers, applies the pass's twiddles from the table and
//    an 8-point DFT (constant twiddles +-1, +-i, (+-1 +-i)/sqrt 2), and the
//    points go through shared memory between passes (the Stockham order
//    ends in natural order, no bit reversal). Its rounding grows as
//    O(log n) where the dense DFT's grew as O(n);
//  * the 4 x 513 power tile never leaves shared memory; each mel sums only
//    its filter's nonzero bins, in ascending bin order as the dense sum did
//    (zeros add nothing to an fp32 sum of non-negative terms), then the log.

#include <cuda_runtime.h>

namespace {

constexpr int MS_NFFT = 1024;
constexpr int MS_NC = MS_NFFT / 2;     // complex points: 512 = 8^3
constexpr int MS_HOP = 320;
constexpr int MS_BINS = MS_NC + 1;     // 513
constexpr int MS_MELS = 64;
constexpr int MS_F = 4;                // frames a block
constexpr int MS_TPF = MS_NC / 8;      // threads a frame: 64, 8 points each
constexpr int MS_THREADS = MS_F * MS_TPF;
constexpr int MS_SEG = (MS_F - 1) * MS_HOP + MS_NFFT;  // 1984 staged samples
// seg, then two (MS_F, 512) complex buffers; the power tile reuses the second.
constexpr int MS_SMEM = (MS_SEG + 2 * 2 * MS_F * MS_NC) * 4;

static_assert(MS_SMEM <= 48 * 1024, "within the default dynamic shared memory: no function attribute to set");
static_assert(MS_TPF == MS_MELS, "the mel pass takes one thread a mel");
static_assert(MS_F * MS_BINS <= 2 * MS_F * MS_NC, "the power tile fits in a buffer");

__device__ __forceinline__ float2 c_add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 c_sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 c_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 c_mul_negi(float2 a) { return make_float2(a.y, -a.x); }  // a * -i

// In place, natural order: a[k] = sum_r a[r] exp(-2 pi i r k / 4).
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = c_add(a0, a2), t1 = c_sub(a0, a2), t2 = c_add(a1, a3), t3 = c_mul_negi(c_sub(a1, a3));
  a0 = c_add(t0, t2);
  a2 = c_sub(t0, t2);
  a1 = c_add(t1, t3);
  a3 = c_sub(t1, t3);
}

// In place, natural order: v[k] = sum_r v[r] exp(-2 pi i r k / 8), as two
// 4-point DFTs of the even and odd points.
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float R2 = 0.70710678118654752f;
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  const float2 o1 = make_float2((v[3].x + v[3].y) * R2, (v[3].y - v[3].x) * R2);   // * exp(-i pi / 4)
  const float2 o2 = c_mul_negi(v[5]);                                              // * -i
  const float2 o3 = make_float2((v[7].y - v[7].x) * R2, -(v[7].x + v[7].y) * R2);  // * exp(-3 i pi / 4)
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = c_add(e0, o0);
  v[4] = c_sub(e0, o0);
  v[1] = c_add(e1, o1);
  v[5] = c_sub(e1, o1);
  v[2] = c_add(e2, o2);
  v[6] = c_sub(e2, o2);
  v[3] = c_add(e3, o3);
  v[7] = c_sub(e3, o3);
}

// One Stockham radix-8 pass of a 512-point FFT for thread j of a frame,
// sub-transforms of NS points so far: v holds in[j + 64 r]; twiddle r by
// W_512^((j % NS) r 64 / NS) = W_1024^(2 ...), DFT, and store to
// out[(j / NS) 8 NS + j % NS + NS r].
template <int NS>
__device__ __forceinline__ void stockham8(float2 (&v)[8], float2* out, const float2* __restrict__ tw, int j) {
  if (NS > 1) {
#pragma unroll
    for (int r = 1; r < 8; ++r) v[r] = c_mul(v[r], __ldg(tw + 2 * (j % NS) * r * (MS_NC / (8 * NS))));
  }
  dft8(v);
  const int d = (j / NS) * 8 * NS + j % NS;
#pragma unroll
  for (int r = 0; r < 8; ++r) out[d + NS * r] = v[r];
}

__global__ void __launch_bounds__(MS_THREADS)
log_mel_fft_kernel(const float* __restrict__ wave, const float* __restrict__ window,
                   const float2* __restrict__ tw, const int2* __restrict__ bands,
                   const float* __restrict__ band_w, int band_stride, float* __restrict__ out,
                   int n_samples, int n_frames, float amin, float ref_db) {
  extern __shared__ __align__(16) float ms_smem[];
  float* seg = ms_smem;  // MS_SEG samples, frame f starts at f * MS_HOP
  float2* buf_a = reinterpret_cast<float2*>(ms_smem + MS_SEG);
  float2* buf_b = buf_a + MS_F * MS_NC;
  float* power = reinterpret_cast<float*>(buf_b);  // MS_F x MS_BINS, once buf_b is read

  const int tid = threadIdx.x, f = tid / MS_TPF, j = tid % MS_TPF;
  const int b = blockIdx.y, f0 = blockIdx.x * MS_F;
  const float* x = wave + (size_t)b * n_samples;

  // The tile's stretch of the centre-padded wave: padded index p is sample
  // p - 512, reflected at both ends without repeating the edge sample
  // (numpy/torch 'reflect'). Samples only frames past the end would read
  // are zero and never stored.
  const int seg_valid = (min(MS_F, n_frames - f0) - 1) * MS_HOP + MS_NFFT;
  for (int i = tid; i < MS_SEG; i += MS_THREADS) {
    float v = 0.f;
    if (i < seg_valid) {
      int g = f0 * MS_HOP + i - MS_NFFT / 2;
      if (g < 0) g = -g;
      if (g >= n_samples) g = 2 * (n_samples - 1) - g;
      v = __ldg(x + g);
    }
    seg[i] = v;
  }
  __syncthreads();

  float2* a = buf_a + f * MS_NC;
  float2* c = buf_b + f * MS_NC;
  float2 v[8];
  {  // pass 1 reads z[n] = (w x)[2n] + i (w x)[2n + 1] straight from the stretch
    const float* xs = seg + f * MS_HOP;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = 2 * (j + MS_TPF * r);
      const float2 w = __ldg(reinterpret_cast<const float2*>(window + n));
      v[r] = make_float2(w.x * xs[n], w.y * xs[n + 1]);
    }
    stockham8<1>(v, a, tw, j);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = a[j + MS_TPF * r];
  stockham8<8>(v, c, tw, j);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = c[j + MS_TPF * r];
  stockham8<64>(v, a, tw, j);
  __syncthreads();

  // The real spectrum and its power: bins j + 64 t, and 512 on thread 0.
  {
    float* pw = power + f * MS_BINS;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int k = j + MS_TPF * t;
      const float2 zk = a[k], zm = a[(MS_NC - k) & (MS_NC - 1)], w = __ldg(tw + k);
      const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
      const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
      const float xr = er + (w.x * di + w.y * dr), xi = ei + (w.y * di - w.x * dr);
      pw[k] = xr * xr + xi * xi;
    }
    if (j == 0) {
      const float d = a[0].x - a[0].y;
      pw[MS_NC] = d * d;
    }
  }
  __syncthreads();

  // Mel j of frame f over its band, ascending bins, then the log.
  const int frame = f0 + f;
  if (frame < n_frames) {
    const int2 band = __ldg(bands + j);
    const float* pw = power + f * MS_BINS;
    const float* wj = band_w + (size_t)j * band_stride - band.x;
    float acc = 0.f;
    for (int k = band.x; k <= band.y; ++k) acc = fmaf(pw[k], __ldg(wj + k), acc);
    out[((size_t)b * n_frames + frame) * MS_MELS + j] = 10.f * log10f(fmaxf(acc, amin)) - ref_db;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaError_t of the launch, 0 on success. Does not synchronise.
extern "C" int mellow_log_mel(const float* wave, const float* window, const void* twiddles,
                              const void* bands, const float* band_w, int band_stride, float* out,
                              int batch, int n_samples, float amin, float ref_db, void* stream) {
  if (n_samples < MS_NC + 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const int n_frames = 1 + n_samples / MS_HOP;
  const dim3 grid((n_frames + MS_F - 1) / MS_F, batch);
  log_mel_fft_kernel<<<grid, MS_THREADS, MS_SMEM, (cudaStream_t)stream>>>(
      wave, window, static_cast<const float2*>(twiddles), static_cast<const int2*>(bands), band_w, band_stride,
      out, n_samples, n_frames, amin, ref_db);
  return (int)cudaGetLastError();
}
