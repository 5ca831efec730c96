// GQA attention for one decode step for Hopper (sm_90a), bf16 cache.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_decode_attention.py
// (flash_gqa_decode): one query token per batch row attends over the
// cached positions; scores and softmax in fp32 with the row's true maximum;
// the unnormalised exp(s - max) is rounded to bf16 before the PV product,
// which accumulates in fp32 and is then divided by the fp32 sum
// (pallas_decode_attention.py _kernel, the bf16-cache branch).
//
// Contract: q (B, H, hd) bf16, roped; k and v are one layer of the port's
// cache, (B, S_max, KV, hd) bf16 with batch stride kv_bstride and position
// stride kv_sstride (elements); positions [0, n) are attended (the caller
// has already written this step's k/v at n - 1, so the TPU kernel's
// "extras" are simply the last cached position here); out (B, H, hd) bf16.
// hd is 8, 16, 32, 64 or 128 and H / KV at most 8 (template parameters
// both); `blocks` (1..16) blocks per (KV head, batch row) split the
// positions. `start` is null, or (B,) int32 on the device: row b then
// attends to positions [start[b], n) only (continuous batching, where a
// row's sequence begins at the cache column it was admitted at). The
// blocks still split [0, n); a block whose positions all lie below
// start[b] holds none and combines as a block past n does. The caller
// keeps start[b] <= n - 1 (the step's own position is always attended).
// The kernel is instantiated with and without a start (template START),
// so a launch without one runs the code it ran before starts existed.
// A second entry point (mellow_decode_attention_devn) reads n from a device
// int32 when the kernel runs, so that a CUDA graph of the decode step
// replays one launch at every position; its split is that of the cache's
// capacity S_max, which at v0's lengths (390-392 of 393) is the host
// launch's split of n (9 blocks of 44 positions), so the bits are the same.
//
// What bounds it: bytes. Each step reads the whole valid cache of a layer,
// 2 * B * n * KV * hd * 2 bytes (at v0, B=1, n ~ 400: 0.3 MB per layer,
// 0.00009 ms at 3.35 TB/s), against ~4 operations per byte: far below the
// ~295 the tensor cores need, so no tensor cores here. In practice the
// kernel is pure latency: one block per (KV head, batch row) was 3 blocks
// on a 132-SM card at v0, each walking all n positions alone.
//
// What the design does about it: one thread-block cluster of `blocks`
// blocks per (KV head, batch row), grid (blocks, KV, B), cluster dimension
// (blocks, 1, 1) set at launch (cudaLaunchKernelEx); the caller takes
// blocks from n so that each block gets about 48 positions (9 blocks at
// v0's lengths: 27 at B=1; at most 16, a non-portable cluster size). The
// kernel's attributes are set once per device, not on every launch. Each
// block keeps its chain of dependent memory round trips short:
//   1. it issues every first load at once (its K rows, its first V rows
//      and q), then scores its slice, a lane pair per position, for all
//      H/KV query heads of the group;
//   2. it pushes its local maxima into every block's shared memory
//      (distributed shared memory, after a barrier arrival made at the
//      start shows that every block is running), and after one cluster
//      barrier each thread takes the global maxima from its own shared
//      memory: exactly the TPU kernel's whole-row max;
//   3. e = exp(s - m), the local fp32 sums (pushed likewise), and the
//      partial PV with bf16(e), the groups of a warp added by shuffles and
//      the warps through shared memory; each block pushes the partial sums
//      of every output to the block that writes it;
//   4. after a second cluster barrier each block adds the cluster's partial
//      sums of its share of the outputs, divides and writes. Nothing reads
//      another block's shared memory after that barrier, so no third one.
// The TPU kernel's rounding points are kept; only the order of the fp32
// sums differs. One launch per call, and no second combine pass.

#include <cooperative_groups.h>

#include "func_attrs.cuh"
#include "bf16_util.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int DTHREADS = 128;
constexpr int DMAX_REP = 8;
constexpr int DMAX_BLOCKS = 16;
constexpr int DNV = 4;  // V rows per thread loaded before the scores
// The dynamic shared memory a launch may ask for (the wrapper checks it).
constexpr int DMAX_DSMEM = 200 * 1024;

// The cluster barrier in two halves: arrive (relaxed) early, wait before
// the first access to another block's shared memory, which must not come
// before every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int HD, int REP, bool START>
__global__ void __launch_bounds__(DTHREADS)
decode_gqa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, bf16* __restrict__ out,
                  const int* __restrict__ start, const int* __restrict__ n_dev, int H, int n_host,
                  int chunk, long long kv_bstride, int kv_sstride, float scale) {
  constexpr int CH = HD / 8;        // 16-byte chunks of a row
  // Chunks each of a position's two lanes scores; at HD = 8 the pair's
  // second lane idles.
  constexpr int HALF = CH > 1 ? CH / 2 : 1;
  constexpr int G = DTHREADS / CH;  // position groups of the PV pass
  constexpr int NW = DTHREADS / 32;
  extern __shared__ __align__(16) float dsm[];
  __shared__ float wred[NW][REP];
  __shared__ float recv_max[DMAX_BLOCKS][REP];  // every block's local maxima
  __shared__ float recv_sum[DMAX_BLOCKS][REP];  // every block's local sums
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int n = n_dev ? __ldg(n_dev) : n_host;
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = (REP * HD + nblk - 1) / nblk;  // outputs each block combines and writes
  float* qs = dsm;                  // REP x HD
  float* ss = qs + REP * HD;        // REP x chunk: scores, then exp
  float* wpart = ss + REP * chunk;  // NW x REP x HD: the warps' partial PV sums
  float* recv_o = wpart + NW * REP * HD;  // nblk x per: every block's partial sums of ours

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // This block's positions: [p0, p0 + len), its share of [0, n) cut at the
  // row's start.
  const int p0 = START ? max(rank * chunk, __ldg(start + b)) : rank * chunk;
  const int len = max(0, min(n, rank * chunk + chunk) - p0);
  const bf16* qb = q + ((size_t)b * H + (size_t)g * REP) * HD;
  const bf16* kb = kc + (size_t)b * kv_bstride + (size_t)p0 * kv_sstride + (size_t)g * HD;
  const bf16* vb = vc + (size_t)b * kv_bstride + (size_t)p0 * kv_sstride + (size_t)g * HD;
  const int sp = tid / 2;               // the position this lane pair scores
  const int sc = (tid % 2) * HALF;      // its first chunk
  const bool scores = CH > 1 || tid % 2 == 0;  // the lane has a chunk to score
  const int grp = tid / CH;             // the PV position group
  const int c8 = (tid % CH) * 8;        // the PV columns

  // Every first load is issued at once: this lane's half of a K row, its
  // first DNV V rows for the PV pass, and q.
  uint4 kreg[HALF];
  if (sp < len && scores)
#pragma unroll
    for (int c = 0; c < HALF; ++c) kreg[c] = ldg16(kb + (size_t)sp * kv_sstride + 8 * (sc + c));
  uint4 vreg[DNV];
#pragma unroll
  for (int i = 0; i < DNV; ++i)
    if (grp + i * G < len) vreg[i] = ldg16(vb + (size_t)(grp + i * G) * kv_sstride + c8);
  for (int i = tid; i < REP * CH; i += DTHREADS) {
    float f[8];
    unpack8(ldg16(qb + 8 * i), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[8 * i + j] = f[j];
  }
  __syncthreads();

  // 1. Scores: a lane pair per position, all query heads of the group; the
  // pair's halves of the dot add through one shuffle.
  float lmax[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) lmax[r] = -1e30f;
  for (int p = sp; p < DTHREADS / 2 * ((len + DTHREADS / 2 - 1) / (DTHREADS / 2)); p += DTHREADS / 2) {
    const bool live = p < len;
    if (p != sp && live && scores)
#pragma unroll
      for (int c = 0; c < HALF; ++c) kreg[c] = ldg16(kb + (size_t)p * kv_sstride + 8 * (sc + c));
    float acc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r] = 0.f;
    if (live && scores) {
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        float f[8];
        unpack8(kreg[c], f);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + r * HD + 8 * (sc + c));
          const float4 qb4 = *reinterpret_cast<const float4*>(qs + r * HD + 8 * (sc + c) + 4);
          acc[r] = fmaf(qa.x, f[0], acc[r]);
          acc[r] = fmaf(qa.y, f[1], acc[r]);
          acc[r] = fmaf(qa.z, f[2], acc[r]);
          acc[r] = fmaf(qa.w, f[3], acc[r]);
          acc[r] = fmaf(qb4.x, f[4], acc[r]);
          acc[r] = fmaf(qb4.y, f[5], acc[r]);
          acc[r] = fmaf(qb4.z, f[6], acc[r]);
          acc[r] = fmaf(qb4.w, f[7], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float s = (acc[r] + __shfl_xor_sync(0xffffffffu, acc[r], 1)) * scale;
      if (live) {
        if (tid % 2 == 0) ss[r * chunk + p] = s;
        lmax[r] = fmaxf(lmax[r], s);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float m = warp_max(lmax[r]);
    if (lane == 0) wred[warp][r] = m;
  }
  __syncthreads();

  // 2. The block's maxima go to every block of the cluster (distributed
  // shared memory, once all have started); after the barrier each thread
  // takes the global maxima, exactly the TPU kernel's whole-row max.
  cluster_wait();
  if (tid < REP) {
    float m = wred[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wred[w][tid]);
    for (int c = 0; c < nblk; ++c) cluster.map_shared_rank(&recv_max[0][0], c)[rank * REP + tid] = m;
  }
  cluster.sync();
  float gmax[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    gmax[r] = recv_max[0][r];
    for (int c = 1; c < nblk; ++c) gmax[r] = fmaxf(gmax[r], recv_max[c][r]);
  }

  // 3. e = exp(s - m) and the block's fp32 sums.
  float lsum[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) lsum[r] = 0.f;
  for (int p = tid; p < len; p += DTHREADS) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float e = expf(ss[r * chunk + p] - gmax[r]);
      ss[r * chunk + p] = e;
      lsum[r] += e;
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float s = warp_sum(lsum[r]);
    if (lane == 0) wred[warp][r] = s;
  }
  __syncthreads();
  if (tid < REP) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += wred[w][tid];
    for (int c = 0; c < nblk; ++c) cluster.map_shared_rank(&recv_sum[0][0], c)[rank * REP + tid] = s;
  }

  // 4. The partial PV: thread (grp, c8) sums positions grp, grp + G, ... of
  // the slice for 8 columns (the DNV rows loaded up front, then four 16-byte
  // V loads in flight); the groups of a warp add through shuffles, the warps
  // through shared memory.
  float oacc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) oacc[r][j] = 0.f;
  auto accumulate = [&](const uint4& u, int p) {
    float f[8];
    unpack8(u, f);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float e = bf16_round(ss[r * chunk + p]);
#pragma unroll
      for (int j = 0; j < 8; ++j) oacc[r][j] = fmaf(e, f[j], oacc[r][j]);
    }
  };
#pragma unroll
  for (int i = 0; i < DNV; ++i)
    if (grp + i * G < len) accumulate(vreg[i], grp + i * G);
  int p = grp + DNV * G;
  for (; p + 3 * G < len; p += 4 * G) {
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = ldg16(vb + (size_t)(p + i * G) * kv_sstride + c8);
#pragma unroll
    for (int i = 0; i < 4; ++i) accumulate(u[i], p + i * G);
  }
  for (; p < len; p += G) accumulate(ldg16(vb + (size_t)p * kv_sstride + c8), p);
#pragma unroll
  for (int o2 = CH; o2 < 32; o2 *= 2)
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) oacc[r][j] += __shfl_xor_sync(0xffffffffu, oacc[r][j], o2);
  if (lane < CH)
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) wpart[(warp * REP + r) * HD + c8 + j] = oacc[r][j];
  __syncthreads();
  // The block's partial sums go to the block that writes them.
  for (int i = tid; i < REP * HD; i += DTHREADS) {
    float s = wpart[i];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += wpart[w * REP * HD + i];
    const int c = i / per;
    cluster.map_shared_rank(recv_o, c)[rank * per + i - c * per] = s;
  }

  // 5. Each block adds every block's partial sums of its outputs, divides
  // by the cluster's sums and writes. Nothing reads another block's shared
  // memory after this barrier.
  cluster.sync();
  const int lo = rank * per;
  const int hi = min(REP * HD, lo + per);
  for (int i = lo + tid; i < hi; i += DTHREADS) {
    const int r = i / HD;
    float s = 0.f, l = 0.f;
    for (int c = 0; c < nblk; ++c) {
      s += recv_o[c * per + i - lo];
      l += recv_sum[c][r];
    }
    out[((size_t)b * H + (size_t)g * REP) * HD + i] = __float2bfloat16(s / l);
  }
}

// `n` sets the split: the host length, or with `n_dev` the cache's capacity.
template <int HD, int REP, bool START>
int launch_decode(const void* q, const void* k, const void* v, void* out, const int* start,
                  const int* n_dev, int B, int H, int KV, int n, long long kv_bstride,
                  int kv_sstride, int blocks, cudaStream_t stream) {
  const int chunk = (n + blocks - 1) / blocks;
  const int per = (REP * HD + blocks - 1) / blocks;
  const size_t smem =
      ((size_t)REP * (HD + chunk + (DTHREADS / 32) * HD) + (size_t)blocks * per) * sizeof(float);
  if (smem > (size_t)DMAX_DSMEM) return (int)cudaErrorInvalidValue;
  auto kernel = decode_gqa_kernel<HD, REP, START>;
  static std::atomic<bool> attrs_set[MELLOW_MAX_DEVICES];
  cudaError_t err = set_func_attrs_once(attrs_set, [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DMAX_DSMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  });
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, KV, B);
  cfg.blockDim = dim3(DTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(out), start, n_dev, H, n,
                           chunk, kv_bstride, kv_sstride, 1.f / sqrtf((float)HD));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_decode_rep(const void* q, const void* k, const void* v, void* out, const int* start,
                      const int* n_dev, int B, int H, int KV, int n, long long kv_bstride,
                      int kv_sstride, int blocks, cudaStream_t stream) {
#define MELLOW_DECODE_REP(R)                                                                        \
  case R:                                                                                           \
    return start ? launch_decode<HD, R, true>(q, k, v, out, start, n_dev, B, H, KV, n, kv_bstride,  \
                                              kv_sstride, blocks, stream)                           \
                 : launch_decode<HD, R, false>(q, k, v, out, start, n_dev, B, H, KV, n, kv_bstride,  \
                                               kv_sstride, blocks, stream);
  switch (H / KV) {
    MELLOW_DECODE_REP(1)
    MELLOW_DECODE_REP(2)
    MELLOW_DECODE_REP(3)
    MELLOW_DECODE_REP(4)
    MELLOW_DECODE_REP(5)
    MELLOW_DECODE_REP(6)
    MELLOW_DECODE_REP(7)
    MELLOW_DECODE_REP(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MELLOW_DECODE_REP
}

int decode_attention(const void* q, const void* k, const void* v, void* out, const void* start,
                     const int* n_dev, int B, int H, int KV, int hd, int n, long long kv_bstride,
                     int kv_sstride, int blocks, void* stream) {
  if (KV < 1 || H % KV || H / KV > DMAX_REP || n < 1 || blocks < 1 || blocks > DMAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s0 = static_cast<const int*>(start);
  switch (hd) {
    case 8: return launch_decode_rep<8>(q, k, v, out, s0, n_dev, B, H, KV, n, kv_bstride, kv_sstride, blocks, st);
    case 16: return launch_decode_rep<16>(q, k, v, out, s0, n_dev, B, H, KV, n, kv_bstride, kv_sstride, blocks, st);
    case 32: return launch_decode_rep<32>(q, k, v, out, s0, n_dev, B, H, KV, n, kv_bstride, kv_sstride, blocks, st);
    case 64: return launch_decode_rep<64>(q, k, v, out, s0, n_dev, B, H, KV, n, kv_bstride, kv_sstride, blocks, st);
    case 128: return launch_decode_rep<128>(q, k, v, out, s0, n_dev, B, H, KV, n, kv_bstride, kv_sstride, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches one kernel on `stream`; returns the cudaError_t, 0 on success.
// Does not synchronise.
// `start`: null, or the (B,) int32 first positions on the device.
extern "C" int mellow_decode_attention(const void* q, const void* k, const void* v, void* out,
                                       const void* start, int B, int H, int KV, int hd, int n,
                                       long long kv_bstride, int kv_sstride, int blocks,
                                       void* stream) {
  return decode_attention(q, k, v, out, start, nullptr, B, H, KV, hd, n, kv_bstride, kv_sstride, blocks,
                          stream);
}

// The same launch with the length on the device: positions [0, *n_dev)
// are attended, read by the kernel when it runs (a CUDA graph replays the
// launch at each step's length). The split is that of `s_max` positions,
// the cache's capacity, which the caller keeps at or above *n_dev; a block
// whose positions all lie at or past *n_dev holds none.
extern "C" int mellow_decode_attention_devn(const void* q, const void* k, const void* v, void* out,
                                            const void* start, const void* n_dev, int B, int H, int KV,
                                            int hd, int s_max, long long kv_bstride, int kv_sstride,
                                            int blocks, void* stream) {
  if (n_dev == nullptr) return (int)cudaErrorInvalidValue;
  return decode_attention(q, k, v, out, start, static_cast<const int*>(n_dev), B, H, KV, hd, s_max,
                          kv_bstride, kv_sstride, blocks, stream);
}
