// Fused log-mel spectrogram for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_melspec.py
// (log_mel_spectrogram_pallas): reflect-pad, frame, Hann-windowed DFT
// against the (1024, 1026) [cos | -sin] basis, power, 513 -> 64 mel
// projection, 10*log10(max(mel, amin)) - ref_db.
//
// Contract: wave (B, n_samples) fp32 contiguous on the device ->
// out (B, 1 + n_samples / 320, 64) fp32. basis (1024, 1026) and fb (513, 64)
// are the tables frontend.dft_basis / frontend.mel_filterbank build.
//
// What bounds it: the DFT is about 2.1 GFLOP per 10 s clip (1001 frames x
// 1024 samples x 1026 columns x 2) against 1.3 MB of wave, so it is bound
// by fp32 FMA throughput on the CUDA cores, and by the loads that feed
// those FMAs. Parity mode's tolerance leaves no room for TF32, so there are
// no tensor cores here.
//
// What the design does about it:
//  * one block per (clip, tile of TILE_F = 8 frames): 126 blocks per clip,
//    so one clip already spreads over the 132 SMs (16-frame tiles left half
//    of them idle at B=1 and measured 18 % slower there). The tile's frames
//    overlap (hop 320 < n_fft 1024), so the block stages the one contiguous
//    stretch of the reflect-padded wave they cover (3,264 samples) in shared
//    memory; reflect indexing happens on that load, so no padded copy of
//    the wave exists;
//  * each thread keeps a 4-frame x 8-bin register tile of re and im sums
//    (64 accumulators): per basis row it reads 4 broadcast samples from
//    shared memory and 16 basis values (lanes on neighbouring columns,
//    coalesced; the 4.2 MB basis stays in the 50 MB L2) for 64 FMAs;
//  * the Nyquist bin (512) is summed apart, 16 lanes per frame with a
//    shuffle reduction, so the main loop has no ragged edge;
//  * the 8 x 513 power tile never leaves shared memory: the mel
//    projection and the log run on it in the same block, which is the
//    point of the TPU kernel too.
// The launcher sets the kernel's dynamic shared memory limit to what it
// uses (29 KB per block; a tile past 48 KB needs that call).

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 1024;
constexpr int HOP = 320;
constexpr int N_BINS = N_FFT / 2 + 1;   // 513
constexpr int N_COLS = 2 * N_BINS;      // 1026: [re | im]
constexpr int N_MELS = 64;
constexpr int TILE_F = 8;               // frames per block
constexpr int THREADS = 128;
constexpr int FRAMES_PER_THREAD = 4;    // register tile: 4 frames ...
constexpr int BIN_GROUPS = 64;          // ... x 8 bins (bg + 64 j, j < 8)
constexpr int BINS_PER_THREAD = 8;
constexpr int SEG = (TILE_F - 1) * HOP + N_FFT;  // 3264 staged samples
constexpr int SMEM_BYTES = (SEG + TILE_F * N_BINS) * sizeof(float);

static_assert(THREADS == BIN_GROUPS * (TILE_F / FRAMES_PER_THREAD), "thread map");
static_assert(BIN_GROUPS * BINS_PER_THREAD == N_BINS - 1, "bins 0..511 in the main loop");
static_assert(THREADS == TILE_F * 16, "Nyquist pass: 16 lanes per frame");
static_assert(THREADS == (N_MELS / 1) * (TILE_F / 4), "mel pass: 4 frames per thread");

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ wave, const float* __restrict__ basis,
               const float* __restrict__ fb, float* __restrict__ out,
               int n_samples, int n_frames, float amin, float ref_db) {
  extern __shared__ float smem[];
  float* seg = smem;          // SEG samples, frame f starts at f * HOP
  float* power = smem + SEG;  // TILE_F x N_BINS

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TILE_F;
  const float* x = wave + (size_t)b * n_samples;

  // Stage the tile's stretch of the centre-padded wave. Padded index p maps
  // to sample p - N_FFT/2, reflected at both ends without repeating the edge
  // sample (numpy/torch 'reflect'). Samples that only frames past the end
  // would read are zero and never used.
  const int last_valid = min(TILE_F, n_frames - f0);
  const int seg_valid = (last_valid - 1) * HOP + N_FFT;
  for (int i = tid; i < SEG; i += THREADS) {
    float v = 0.f;
    if (i < seg_valid) {
      int g = f0 * HOP + i - N_FFT / 2;
      if (g < 0) g = -g;
      if (g >= n_samples) g = 2 * (n_samples - 1) - g;
      v = __ldg(x + g);
    }
    seg[i] = v;
  }
  __syncthreads();

  // Windowed DFT, bins 0..511: thread (fg, bg) owns frames 4 fg .. 4 fg + 3
  // and bins bg + 64 j. A warp shares fg, so its sample reads broadcast.
  {
    const int bg = tid % BIN_GROUPS;
    const int fg = tid / BIN_GROUPS;
    const float* xs = seg + fg * FRAMES_PER_THREAD * HOP;
    float re[FRAMES_PER_THREAD][BINS_PER_THREAD];
    float im[FRAMES_PER_THREAD][BINS_PER_THREAD];
#pragma unroll
    for (int f = 0; f < FRAMES_PER_THREAD; ++f)
#pragma unroll
      for (int j = 0; j < BINS_PER_THREAD; ++j) re[f][j] = im[f][j] = 0.f;

#pragma unroll 2
    for (int n = 0; n < N_FFT; ++n) {
      const float* row = basis + (size_t)n * N_COLS + bg;
      float c[BINS_PER_THREAD], s[BINS_PER_THREAD];
#pragma unroll
      for (int j = 0; j < BINS_PER_THREAD; ++j) {
        c[j] = __ldg(row + BIN_GROUPS * j);
        s[j] = __ldg(row + N_BINS + BIN_GROUPS * j);
      }
#pragma unroll
      for (int f = 0; f < FRAMES_PER_THREAD; ++f) {
        const float v = xs[f * HOP + n];
#pragma unroll
        for (int j = 0; j < BINS_PER_THREAD; ++j) {
          re[f][j] = fmaf(v, c[j], re[f][j]);
          im[f][j] = fmaf(v, s[j], im[f][j]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FRAMES_PER_THREAD; ++f)
#pragma unroll
      for (int j = 0; j < BINS_PER_THREAD; ++j)
        power[(fg * FRAMES_PER_THREAD + f) * N_BINS + bg + BIN_GROUPS * j] =
            re[f][j] * re[f][j] + im[f][j] * im[f][j];
  }

  // Nyquist bin 512 (columns 512 and 1025): 16 lanes per frame, each over
  // every 16th sample, then a shuffle reduction inside the 16-lane group.
  {
    const int f = tid / 16;
    const int l = tid % 16;
    const float* xs = seg + f * HOP;
    float re = 0.f, im = 0.f;
    for (int n = l; n < N_FFT; n += 16) {
      const float v = xs[n];
      re = fmaf(v, __ldg(basis + (size_t)n * N_COLS + N_BINS - 1), re);
      im = fmaf(v, __ldg(basis + (size_t)n * N_COLS + N_COLS - 1), im);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      re += __shfl_xor_sync(0xffffffffu, re, o);
      im += __shfl_xor_sync(0xffffffffu, im, o);
    }
    if (l == 0) power[f * N_BINS + N_BINS - 1] = re * re + im * im;
  }
  __syncthreads();

  // Mel projection and log: thread (fq, m) owns mel m of frames 4 fq .. +3.
  {
    const int m = tid % N_MELS;
    const int fq = tid / N_MELS;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < N_BINS; ++k) {
      const float w = __ldg(fb + k * N_MELS + m);
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[f] = fmaf(power[(fq * 4 + f) * N_BINS + k], w, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int frame = f0 + fq * 4 + f;
      if (frame < n_frames)
        out[((size_t)b * n_frames + frame) * N_MELS + m] =
            10.f * log10f(fmaxf(acc[f], amin)) - ref_db;
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer); returns the
// cudaError_t of the launch, 0 on success. Does not synchronise.
extern "C" int mellow_log_mel(const float* wave, const float* basis, const float* fb,
                              float* out, int batch, int n_samples, float amin,
                              float ref_db, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_frames = 1 + n_samples / HOP;
  const dim3 grid((n_frames + TILE_F - 1) / TILE_F, batch);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      wave, basis, fb, out, n_samples, n_frames, amin, ref_db);
  return (int)cudaGetLastError();
}
