// GQA attention for one decode step over an int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_decode_attention.py
// (flash_gqa_decode_tiled, the group-tiled int8 kernel, whose math is
// flash_gqa_decode's int8 branch): per query head, q is quantized to int8
// with its own scale; scores are int8 x int8 dots with the per-position k
// scales folded in after; the flush window's pending rows and the step's
// own row ride in bf16 as E extra positions (the TPU kernel's ex_ref rows,
// pallas_decode_attention._kernel_tiled), sharing the score max and the
// fp32 sum; the softmax weights times the per-position v scales are
// re-quantized to int8 (by truncation) for an int8 x int8 value dot; the
// extras' value sum, bf16(exp) times the bf16 rows in fp32, is added and
// the sum is normalised.
//
// Contract: q (B, H, hd) bf16, roped; k8 and v8 are one layer of the
// port's int8 cache, (B, S_max, KV, hd), batch stride kv_bstride and
// position stride kv_sstride (elements, multiples of 16); k_scale and
// v_scale (B, S_max) fp32 with batch stride sc_bstride; k_extra and
// v_extra (B, E, KV, hd) bf16 with batch stride ex_bstride (elements) and
// contiguous (E, KV, hd) rows, 1 <= E <= 8, every row live: the window's
// pending rows, then this step's; positions [0, n) of the cache are
// attended, plus the E extra rows. out (B, H, hd) bf16. hd is a multiple
// of 16, at most 128; H / KV <= 8; `blocks` (1..16) blocks per (KV group,
// batch row) split the positions. `start` is null, or (B,) int32 on the
// device: row b then attends to cached positions [start[b], n) only, plus
// its extra rows, which lie past start[b] (continuous batching). The
// blocks still split [0, n); a block whose positions all lie below
// start[b] holds none and combines as a block past n does, so a row with
// no cached position left attends to its extra rows alone. The kernel is
// instantiated with and without a start (template START), so a launch
// without one runs the code it ran before starts existed.
//
// What bounds it: bytes. A step reads a layer's valid int8 cache and its
// scales, 2 * B * n * (KV * hd + 4) bytes (at v0, B=1, n ~ 400: 0.15 MB,
// 0.00005 ms at 3.35 TB/s), against ~4 integer operations per byte, far
// below what the tensor cores need. In practice the kernel is latency: one
// block per (KV group, batch row) was 3 blocks on 132 SMs at v0, each
// walking all n positions alone through a dozen block barriers.
//
// What the design does about it: one thread-block cluster of `blocks`
// blocks per (KV group, batch row), grid (blocks, KV, B), the cluster
// dimension set at launch (cudaLaunchKernelEx); the caller takes blocks
// from n (about 48 positions a block). The attributes are set once per
// device. Each block keeps its chain of dependent round trips short:
//   0. it issues every first load at once: the k8 rows of its slice (a lane
//      pair per position, 16-byte loads), their k and v scales, its first
//      v8 words for the value pass, q and the extra k rows at each lane's
//      dims, and the extra v rows its outputs need (raw bits from clamped
//      addresses, so that no load waits behind another's use);
//   1. it quantizes q itself, a warp per head from its own loads (cheap and
//      exact: every block holds the same q8 and qmax), and scores the E
//      extra rows, warp w taking rows w and w + 4 of every head with the
//      shuffle sums of all its (head, row) pairs interleaved, so E = 8
//      costs about what E = 1 does. Every block scores the extras, so its
//      maximum includes them;
//   2. it scores its slice, __dp4a into exact int32 sums, all H/KV heads at
//      once;
//   exchange 1 (distributed shared memory): the local maxima; each block
//      then holds the exact global maximum m;
//   3. e = exp(s - m), the local sum, w = e * v_scale (unnormalised, as in
//      the TPU kernel) and the local max of w, a thread per position, while
//      threads the slice leaves idle form exp(s_x - m) of the extras;
//   exchange 2: the sums and the maxima of w together;
//   4. the owners of the outputs form their extras' value sum and their
//      denominator beside the w8 pass;
//   5. w8 = trunc(w * 127 / wmax) and the int32 partial w8 . v8 over the
//      slice: a thread takes 4 columns of 4 positions at a time, their v8
//      words transposed with byte permutes into one word per column for
//      __dp4a;
//   exchange 3: the int32 partials go to the block that owns each output,
//      which adds them (exact in any order), divides and writes.
// Every rounded quantity is the one of the single-block kernel this one
// replaced, operation for operation, except the fp32 sum of e, whose order
// follows the split: at blocks = 1 the output is bit for bit the previous
// kernel's, and any two cluster sizes agree within one bf16 ulp.
//
// Measured on an H100 (PERF.md): a launch's device time is ~12 us at v0's
// shapes, of which ~5 us is what an empty launch reads and ~1.4 us the
// three cluster barriers. Tried and dropped: the nblk loops kept rolled
// (slower), and atomicMax slots in distributed shared memory in place of
// two block barriers (slower).

#include <cooperative_groups.h>

#include "func_attrs.cuh"
#include "bf16_util.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int ITHREADS = 128;
constexpr int INW = ITHREADS / 32;
constexpr int IMAX_EXTRA = 8;
constexpr int IMAX_BLOCKS = 16;
constexpr int IMAX_HD = 128;
constexpr int IDNV = 8;  // v8 words per thread loaded before the scores
// The dynamic shared memory a launch may ask for (the wrapper checks it).
constexpr int IMAX_DSMEM = 200 * 1024;
// The most positions whose int32 value sum w8 . v8 cannot overflow.
constexpr int IMAX_N = 2147483647 / (127 * 127);

// The cluster barrier in two halves: arrive (relaxed) early, wait before
// the first access to another block's shared memory.
__device__ __forceinline__ void i8_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void i8_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__host__ __device__ constexpr size_t i8_align16(size_t x) { return (x + 15) & ~(size_t)15; }

// A block's dynamic shared memory (byte offsets, each region 16-byte
// aligned): the slice's scores, then w (rep x chunk fp32); q8 (rep x hd);
// the slice's w8 (rep x chunk rounded up to 4); the value pass's partial
// sums (groups x rep x hd int32); the partial sums of the block's outputs
// from every block (blocks x per int32).
struct Int8Smem {
  int chunk, chunk4, per, groups;
  size_t ss, q8, w8, part, recv_o, bytes;
};

__host__ __device__ inline Int8Smem int8_smem(int rep, int hd, int n, int blocks) {
  Int8Smem s;
  s.chunk = (n + blocks - 1) / blocks;
  s.chunk4 = (s.chunk + 3) & ~3;
  s.per = (rep * hd + blocks - 1) / blocks;
  s.groups = ITHREADS / (hd / 4);
  size_t o = 0;
  s.ss = o;
  o += i8_align16((size_t)rep * s.chunk * 4);
  s.q8 = o;
  o += i8_align16((size_t)rep * hd);
  s.w8 = o;
  o += i8_align16((size_t)rep * s.chunk4);
  s.part = o;
  o += i8_align16((size_t)s.groups * rep * hd * 4);
  s.recv_o = o;
  o += i8_align16((size_t)blocks * s.per * 4);
  s.bytes = o;
  return s;
}

template <int REP, bool START>
__global__ void __launch_bounds__(ITHREADS)
decode_gqa_int8_kernel(const bf16* __restrict__ q, const signed char* __restrict__ kc,
                       const signed char* __restrict__ vc, const float* __restrict__ ksc,
                       const float* __restrict__ vsc, const bf16* __restrict__ kex,
                       const bf16* __restrict__ vex, bf16* __restrict__ out,
                       const int* __restrict__ start, int H, int KV,
                       int hd, int n, int E, long long kv_bstride, int kv_sstride,
                       long long sc_bstride, long long ex_bstride, float scale,
                       float score_scale) {
  constexpr int QK = IMAX_HD / 32;  // a lane's dims of a row: lane, lane + 32, ...
  extern __shared__ __align__(16) unsigned char ism[];
  __shared__ float red_max[INW][REP], red_sum[INW][REP], red_w[INW][REP];
  __shared__ float qmax_s[REP], sx_s[REP][IMAX_EXTRA], ex_s[REP][IMAX_EXTRA];
  __shared__ float recv_max[IMAX_BLOCKS][REP];   // every block's local maxima
  __shared__ float recv_sum[IMAX_BLOCKS][REP];   // every block's local sums of e
  __shared__ float recv_wmax[IMAX_BLOCKS][REP];  // every block's local maxima of w
  cg::cluster_group cluster = cg::this_cluster();
  i8_cluster_arrive_relaxed();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Int8Smem L = int8_smem(REP, hd, n, nblk);
  const int chunk = L.chunk, chunk4 = L.chunk4, per = L.per, groups = L.groups;
  float* ss = reinterpret_cast<float*>(ism + L.ss);
  signed char* q8s = reinterpret_cast<signed char*>(ism + L.q8);
  signed char* w8s = reinterpret_cast<signed char*>(ism + L.w8);
  int* part = reinterpret_cast<int*>(ism + L.part);
  int* recv_o = reinterpret_cast<int*>(ism + L.recv_o);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // This block's positions: [p0, p0 + len), its share of [0, n) cut at the
  // row's start.
  const int p0 = START ? max(rank * chunk, __ldg(start + b)) : rank * chunk;
  const int len = max(0, min(n, rank * chunk + chunk) - p0);
  const int len4 = (len + 3) & ~3;
  const bf16* qb = q + ((size_t)b * H + (size_t)g * REP) * hd;
  const signed char* kb = kc + (size_t)b * kv_bstride + (size_t)p0 * kv_sstride + (size_t)g * hd;
  const signed char* vb = vc + (size_t)b * kv_bstride + (size_t)p0 * kv_sstride + (size_t)g * hd;
  const float* ksb = ksc + (size_t)b * sc_bstride + p0;
  const float* vsb = vsc + (size_t)b * sc_bstride + p0;
  // Extra row e of this group: kxb + e * KV * hd.
  const bf16* kxb = kex + (size_t)b * ex_bstride + (size_t)g * hd;
  const bf16* vxb = vex + (size_t)b * ex_bstride + (size_t)g * hd;
  const int ex_sstride = KV * hd;
  const int chunks = hd / 16;          // 16-byte chunks of a k8 row
  const int sp = tid / 2;              // the position this lane pair scores
  const int side = tid % 2;            // the lane takes chunks side, side + 2, ...
  const int tpr = hd / 4;              // value pass: threads per row, 4 columns each
  const int grp = tid / tpr;           // its group of 4-position blocks
  const int c4 = (tid % tpr) * 4;      // its columns
  const bool vlane = grp < groups;
  const int lo = rank * per;           // the outputs this block owns
  const int hi = min(REP * hd, lo + per);
  // Output lo + j belongs to thread (j + 64) % 128, so that the first 64
  // outputs' owners are threads the w8 pass of a short slice leaves idle.
  const int oi = lo + ((tid + ITHREADS / 2) % ITHREADS);  // this thread's first owned output

  // 0. Every first load at once: the pair's k8 row and k scale, the
  // thread's v scale and its first two 4-position blocks of v8 words, q and
  // the warp's extra k rows at the lane's dims, and the extra v rows at the
  // column of the thread's first owned output.
  int4 kreg[IMAX_HD / 32];
  float ks0 = 0.f;
  if (sp < len) {
#pragma unroll
    for (int c = 0; c < IMAX_HD / 32; ++c)
      if (side + 2 * c < chunks)
        kreg[c] = __ldg(reinterpret_cast<const int4*>(kb + (size_t)sp * kv_sstride + 16 * (side + 2 * c)));
    ks0 = __ldg(ksb + sp);
  }
  const float vs0 = tid < len ? __ldg(vsb + tid) : 0.f;
  int vreg[IDNV];
#pragma unroll
  for (int i = 0; i < IDNV; ++i) {
    const int p = 4 * (grp + (i / 4) * groups) + i % 4;
    vreg[i] = vlane && p < len ? __ldg(reinterpret_cast<const int*>(vb + (size_t)p * kv_sstride + c4)) : 0;
  }
  // q, the extra rows: raw bf16 bits from clamped (always valid) addresses,
  // every load issued before any is used; the lanes past hd and the rows
  // past E are zeroed after.
  const unsigned short* q16 = reinterpret_cast<const unsigned short*>(qb);
  const unsigned short* kx16 = reinterpret_cast<const unsigned short*>(kxb);
  const unsigned short* vx16 = reinterpret_cast<const unsigned short*>(vxb);
  unsigned short qraw[REP][QK], kxraw[2][QK], vxraw[IMAX_EXTRA];
#pragma unroll
  for (int k = 0; k < QK; ++k) {
    const int d = min(lane + 32 * k, hd - 1);
#pragma unroll
    for (int r = 0; r < REP; ++r) qraw[r][k] = __ldg(q16 + r * hd + d);
    // Warp w scores the extra rows w and w + 4 (for every head).
#pragma unroll
    for (int t = 0; t < 2; ++t) kxraw[t][k] = __ldg(kx16 + (size_t)min(warp + INW * t, E - 1) * ex_sstride + d);
  }
#pragma unroll
  for (int e = 0; e < IMAX_EXTRA; ++e) vxraw[e] = __ldg(vx16 + (size_t)min(e, E - 1) * ex_sstride + oi % hd);
  const auto bits = [](unsigned short u) { return __uint_as_float((unsigned)u << 16); };
  float qv[REP][QK], kx[2][QK], vx[IMAX_EXTRA];
#pragma unroll
  for (int k = 0; k < QK; ++k) {
    const bool in = lane + 32 * k < hd;
#pragma unroll
    for (int r = 0; r < REP; ++r) qv[r][k] = in ? bits(qraw[r][k]) : 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) kx[t][k] = in && warp + INW * t < E ? bits(kxraw[t][k]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < IMAX_EXTRA; ++e) vx[e] = e < E ? bits(vxraw[e]) : 0.f;

  // 1. Head r's max|q| and q8 (warp r % 4), from the lane's own loads; and
  // the extras' scores (fp32 from bf16, exact products): each lane sums its
  // dims in order, then the warp's shuffle sums of all its (head, extra
  // row) pairs run interleaved.
#pragma unroll
  for (int r = 0; r < REP; ++r)
    if (r % INW == warp) {
      float amax = 0.f;
#pragma unroll
      for (int k = 0; k < QK; ++k) amax = fmaxf(amax, fabsf(qv[r][k]));
      const float qm = fmaxf(warp_max(amax), 1e-8f);
      const float inv = 127.f / qm;
#pragma unroll
      for (int k = 0; k < QK; ++k)
        if (lane + 32 * k < hd) q8s[r * hd + lane + 32 * k] = (signed char)(int)rintf(__fmul_rn(qv[r][k], inv));
      if (lane == 0) qmax_s[r] = qm;
    }
  float xd[REP][2];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      xd[r][t] = 0.f;
#pragma unroll
      for (int k = 0; k < QK; ++k)
        if (lane + 32 * k < hd) xd[r][t] += qv[r][k] * kx[t][k];
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int t = 0; t < 2; ++t) xd[r][t] += __shfl_xor_sync(0xffffffffu, xd[r][t], o);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (warp + INW * t < E) sx_s[r][warp + INW * t] = xd[r][t] * scale;
  __syncthreads();

  // 2. Scores of the slice: a lane pair per position, all heads of the
  // group; the pair's halves of the int32 dot add through one shuffle.
  float qc[REP], lmax[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    qc[r] = __fmul_rn(qmax_s[r], score_scale);
    lmax[r] = -1e30f;
  }
  for (int base = 0; base < len; base += ITHREADS / 2) {
    const int p = base + sp;
    const bool live = p < len;
    if (base > 0 && live) {
#pragma unroll
      for (int c = 0; c < IMAX_HD / 32; ++c)
        if (side + 2 * c < chunks)
          kreg[c] = __ldg(reinterpret_cast<const int4*>(kb + (size_t)p * kv_sstride + 16 * (side + 2 * c)));
      ks0 = __ldg(ksb + p);
    }
    int acc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r] = 0;
    if (live) {
#pragma unroll
      for (int c = 0; c < IMAX_HD / 32; ++c)
        if (side + 2 * c < chunks) {
          const int4 k4 = kreg[c];
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const int4 q4 = *reinterpret_cast<const int4*>(q8s + r * hd + 16 * (side + 2 * c));
            acc[r] = __dp4a(k4.x, q4.x, acc[r]);
            acc[r] = __dp4a(k4.y, q4.y, acc[r]);
            acc[r] = __dp4a(k4.z, q4.z, acc[r]);
            acc[r] = __dp4a(k4.w, q4.w, acc[r]);
          }
        }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const int dot = acc[r] + __shfl_xor_sync(0xffffffffu, acc[r], 1);
      if (live) {
        const float s = __fmul_rn(__fmul_rn((float)dot, qc[r]), ks0);
        if (side == 0) ss[r * chunk + p] = s;
        lmax[r] = fmaxf(lmax[r], s);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float m = warp_max(lmax[r]);
    if (lane == 0) red_max[warp][r] = m;
  }
  __syncthreads();

  // Exchange 1: the block's maxima (the extras' included) to every block of
  // the cluster, once all have started; then each thread takes the global
  // maxima from its own shared memory.
  i8_cluster_wait();
  if (tid < REP) {
    float m = sx_s[tid][0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, sx_s[tid][e]);
#pragma unroll
    for (int w = 0; w < INW; ++w) m = fmaxf(m, red_max[w][tid]);
    for (int c = 0; c < nblk; ++c) cluster.map_shared_rank(&recv_max[0][0], c)[rank * REP + tid] = m;
  }
  cluster.sync();
  float gmax[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    gmax[r] = recv_max[0][r];
    for (int c = 1; c < nblk; ++c) gmax[r] = fmaxf(gmax[r], recv_max[c][r]);
  }

  // exp(s_x - m) of every (head, extra row), by threads 64.. (idle in step
  // 3 when the slice holds at most 64 positions), for the owners after the
  // next barrier.
  {
    const int j = tid - ITHREADS / 2;
    if (j >= 0 && j < REP * IMAX_EXTRA && (j % IMAX_EXTRA) < E) {
      const int r = j / IMAX_EXTRA;
      float m = recv_max[0][r];
      for (int c = 1; c < nblk; ++c) m = fmaxf(m, recv_max[c][r]);
      ex_s[r][j % IMAX_EXTRA] = expf(sx_s[r][j % IMAX_EXTRA] - m);
    }
  }
  // The owner's extras' sum and value sum (bf16(exp) x bf16 is exact in
  // fp32, the adds round in row order), its denominator (the cluster's sum
  // of e plus the extras') and its scale.
  auto owner_prep = [&](int i, const float (&vxi)[IMAX_EXTRA], float& coef, float& xv, float& den) {
    const int r = i / hd;
    float xs = 0.f, wm = 0.f, l = 0.f;
    xv = 0.f;
#pragma unroll
    for (int e = 0; e < IMAX_EXTRA; ++e)
      if (e < E) {
        const float ex = ex_s[r][e];
        xs += ex;
        xv = __fadd_rn(xv, __fmul_rn(bf16_round(ex), vxi[e]));
      }
    for (int c = 0; c < nblk; ++c) {
      wm = fmaxf(wm, recv_wmax[c][r]);
      l += recv_sum[c][r];
    }
    coef = fmaxf(wm, 1e-30f) / 127.f;
    den = l + xs;
  };

  // 3. e = exp(s - m), its local sum, and w = e * v_scale with its local
  // max; a thread per position (w of the first kept in registers).
  float lsum[REP], lw[REP], w0[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    lsum[r] = 0.f;
    lw[r] = 0.f;
    w0[r] = 0.f;
  }
  for (int p = tid; p < len; p += ITHREADS) {
    const float vs = p == tid ? vs0 : __ldg(vsb + p);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float e = expf(ss[r * chunk + p] - gmax[r]);
      lsum[r] += e;
      const float w = __fmul_rn(e, vs);
      ss[r * chunk + p] = w;
      if (p == tid) w0[r] = w;
      lw[r] = fmaxf(lw[r], w);
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float s = warp_sum(lsum[r]);
    const float m = warp_max(lw[r]);
    if (lane == 0) {
      red_sum[warp][r] = s;
      red_w[warp][r] = m;
    }
  }
  __syncthreads();

  // Exchange 2: the block's sums and maxima of w together.
  if (tid < REP) {
    float s = 0.f, m = 0.f;
#pragma unroll
    for (int w = 0; w < INW; ++w) {
      s += red_sum[w][tid];
      m = fmaxf(m, red_w[w][tid]);
    }
    for (int c = 0; c < nblk; ++c) {
      cluster.map_shared_rank(&recv_sum[0][0], c)[rank * REP + tid] = s;
      cluster.map_shared_rank(&recv_wmax[0][0], c)[rank * REP + tid] = m;
    }
  }
  cluster.sync();

  // 4. The owner's preparation, beside the w8 pass.
  float coef0 = 0.f, xv0 = 0.f, den0 = 1.f;
  if (oi < hi) owner_prep(oi, vx, coef0, xv0, den0);

  // 5. w8 = trunc(w * 127 / wmax) (w >= 0, and the cast truncates as the TPU
  // kernel's astype(int8) does), a thread per position, zero past the slice
  // up to a whole block of 4.
  float inv[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float m = 0.f;
    for (int c = 0; c < nblk; ++c) m = fmaxf(m, recv_wmax[c][r]);
    inv[r] = 127.f / fmaxf(m, 1e-30f);
  }
  for (int p = tid; p < len4; p += ITHREADS)
#pragma unroll
    for (int r = 0; r < REP; ++r)
      w8s[r * chunk4 + p] =
          p < len ? (signed char)(int)__fmul_rn(p == tid ? w0[r] : ss[r * chunk + p], inv[r]) : 0;
  __syncthreads();

  // The value pass: thread (grp, c4) takes the 4-position blocks grp,
  // grp + groups, ... of the slice for 4 columns; the four positions' v8
  // words are transposed to one word per column, so that __dp4a sums
  // w8 * v8 over the four positions exactly.
  if (vlane) {
    int acc[REP][4];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    auto accumulate = [&](const int (&u)[4], int blk) {
      const int x0 = __byte_perm(u[0], u[1], 0x5140), x1 = __byte_perm(u[2], u[3], 0x5140);
      const int x2 = __byte_perm(u[0], u[1], 0x7362), x3 = __byte_perm(u[2], u[3], 0x7362);
      const int col[4] = {(int)__byte_perm(x0, x1, 0x5410), (int)__byte_perm(x0, x1, 0x7632),
                          (int)__byte_perm(x2, x3, 0x5410), (int)__byte_perm(x2, x3, 0x7632)};
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const int w4 = *reinterpret_cast<const int*>(w8s + r * chunk4 + 4 * blk);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(col[j], w4, acc[r][j]);
      }
    };
#pragma unroll
    for (int i = 0; i < IDNV / 4; ++i) {
      const int blk = grp + i * groups;
      if (4 * blk < len4) {
        const int u[4] = {vreg[4 * i], vreg[4 * i + 1], vreg[4 * i + 2], vreg[4 * i + 3]};
        accumulate(u, blk);
      }
    }
    for (int blk = grp + (IDNV / 4) * groups; 4 * blk < len4; blk += groups) {
      int u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = 4 * blk + k < len ? __ldg(reinterpret_cast<const int*>(vb + (size_t)(4 * blk + k) * kv_sstride + c4)) : 0;
      accumulate(u, blk);
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
      *reinterpret_cast<int4*>(part + (grp * REP + r) * hd + c4) =
          make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();

  // Exchange 3: the block's int32 partial sums to the block that owns each
  // output (block c owns outputs [c per, (c + 1) per) of the group's REP x hd).
  for (int i = tid; i < REP * hd; i += ITHREADS) {
    int s = 0;
    for (int gg = 0; gg < groups; ++gg) s += part[gg * REP * hd + i];
    const int c = i / per;
    cluster.map_shared_rank(recv_o, c)[rank * per + i - c * per] = s;
  }
  cluster.sync();

  // Nothing reads another block's shared memory after the last barrier.
  bf16* ob = out + ((size_t)b * H + (size_t)g * REP) * hd;
  for (int i = oi; i < hi; i += ITHREADS) {
    float coef = coef0, xv = xv0, den = den0;
    if (i != oi) {  // a second output: one block holds more than 128
      float vxi[IMAX_EXTRA];
#pragma unroll
      for (int e = 0; e < IMAX_EXTRA; ++e) vxi[e] = e < E ? bf2f(vxb[(size_t)e * ex_sstride + i % hd]) : 0.f;
      owner_prep(i, vxi, coef, xv, den);
    }
    int s = 0;
    for (int c = 0; c < nblk; ++c) s += recv_o[c * per + i - lo];
    ob[i] = __float2bfloat16(__fadd_rn(__fmul_rn((float)s, coef), xv) / den);
  }
}

template <int REP, bool START>
int launch_int8_decode(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                       const void* kex, const void* vex, void* out, const int* start, int B, int H,
                       int KV, int hd, int n, int E, long long kv_bstride, int kv_sstride,
                       long long sc_bstride, long long ex_bstride, int blocks, cudaStream_t stream) {
  const Int8Smem L = int8_smem(REP, hd, n, blocks);
  if (L.bytes > (size_t)IMAX_DSMEM) return (int)cudaErrorInvalidValue;
  auto kernel = decode_gqa_int8_kernel<REP, START>;
  static std::atomic<bool> attrs_set[MELLOW_MAX_DEVICES];
  cudaError_t err = set_func_attrs_once(attrs_set, [&] {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, IMAX_DSMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  });
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, KV, B);
  cfg.blockDim = dim3(ITHREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = 1.f / sqrtf((float)hd);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const signed char*>(k),
                           static_cast<const signed char*>(v), static_cast<const float*>(ks),
                           static_cast<const float*>(vs), static_cast<const bf16*>(kex),
                           static_cast<const bf16*>(vex), static_cast<bf16*>(out), start, H, KV, hd, n, E,
                           kv_bstride, kv_sstride, sc_bstride, ex_bstride, scale, scale / 127.f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one kernel on `stream`; returns the cudaError_t, 0 on success.
// Does not synchronise. `start`: null, or the (B,) int32 first positions on
// the device.
extern "C" int mellow_decode_attention_int8(const void* q, const void* k, const void* v,
                                            const void* ks, const void* vs, const void* kex,
                                            const void* vex, void* out, const void* start,
                                            int B, int H, int KV,
                                            int hd, int n, int E, long long kv_bstride,
                                            int kv_sstride, long long sc_bstride,
                                            long long ex_bstride, int blocks, void* stream) {
  const int rep = KV > 0 ? H / KV : 0;
  if (KV < 1 || rep * KV != H || hd % 16 != 0 || hd < 16 || hd > IMAX_HD || n < 1 || n > IMAX_N ||
      kv_sstride % 16 != 0 || kv_bstride % 16 != 0 || E < 1 || E > IMAX_EXTRA || blocks < 1 ||
      blocks > IMAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s0 = static_cast<const int*>(start);
#define MELLOW_INT8_DECODE(R)                                                                        \
  case R:                                                                                            \
    return s0 ? launch_int8_decode<R, true>(q, k, v, ks, vs, kex, vex, out, s0, B, H, KV, hd, n, E,   \
                                            kv_bstride, kv_sstride, sc_bstride, ex_bstride, blocks, st) \
              : launch_int8_decode<R, false>(q, k, v, ks, vs, kex, vex, out, s0, B, H, KV, hd, n, E,  \
                                             kv_bstride, kv_sstride, sc_bstride, ex_bstride, blocks, st);
  switch (rep) {
    MELLOW_INT8_DECODE(1)
    MELLOW_INT8_DECODE(2)
    MELLOW_INT8_DECODE(3)
    MELLOW_INT8_DECODE(4)
    MELLOW_INT8_DECODE(5)
    MELLOW_INT8_DECODE(6)
    MELLOW_INT8_DECODE(7)
    MELLOW_INT8_DECODE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MELLOW_INT8_DECODE
}
