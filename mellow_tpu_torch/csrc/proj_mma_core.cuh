// The projection GEMMs of the prefill attention blocks (#4 fused_attn_block,
// #5 fused_attn_block_w8a8) for Hopper (sm_90a), and the dense products of
// the prefill MLP block (#6 fused_mlp_block) and the Swin block (#8
// swin_block_fused) on the same mainloop (their section below); the W8A8
// MLP block (#7, mlp_block_w8a8.cu) builds its two launches from the int8
// pieces (pj_quantize_rows, pj_mma_s8_stage, pj_quant, dense_split). In the
// projections a block owns 16 * MW rows (MW warps, 16 rows each) and one
// 64-column tile of the output, which is one head of q, k or v, or 64
// columns of the o-projection.
//
//   q/k/v launch: every column tile of [wq | wk | wv] in one grid; a tile
//     picks its weight, its destination and its epilogue (RoPE into the q
//     scratch, RoPE into the strided k rows, a store into the v rows);
//   o launch:     out = bf16(x + bf16(o @ wo)).
//
// The block's A operand is a panel of whole rows (all K columns) in shared
// memory, formed once before the mainloop; each warp loads, and in the
// q/k/v launch normalises, its own 16 rows, so the panel needs no block
// barrier of its own:
//   bf16: h = bf16(x * rsqrt(mean(x^2) + eps) * gamma), the row statistics
//     in a fixed order (pj_norm_rows: one warp a row, lanes 8 columns
//     wide, then a butterfly), the order the digests of the port's bf16
//     kernels were recorded with;
//   int8 (q/k/v): rowquant_kernel's arithmetic: the fp32 norm, not
//     rounded, its sum of squares in rowquant's order (one warp a row,
//     lanes striding one column, warp_sum), then sc = max(max|h|, 1e-8) /
//     127 and q = clip(rint(h / sc), -127, 127) (order-free; the division
//     without a divide, pj_quant). The int8 rows and scales are those
//     rowquant_kernel writes, bit for bit, and never reach device memory.
//   int8 (o): o8 and its row scales come from rowquant_kernel (a launch of
//     its own); each 16-byte chunk is put in the panel's k order.
// All 16 rows of a warp go through each pass side by side, so that 16
// independent chains hide each other's latency.
// The weight (row-major (K, cols)) streams through a ring of PJ_STAGES
// stages of 32 rows x 64 columns, filled by 16-byte cp.async with
// commit/wait groups (flash_prefill_core.cuh's fp_* helpers); rows past K
// and columns past the weight's width arrive as zeros.
//
// The products are mma.sync in registers, each warp a 16 x 64 tile:
//   bf16: m16n8k16 with fp32 accumulators; A by ldmatrix from the panel, B
//     by ldmatrix.trans from the ring.
//   int8: m16n8k32 s8 x s8 -> s32. ldmatrix.trans moves 16-bit elements,
//     so it cannot hand a thread the four consecutive k of one int8
//     column that the B fragment wants. Instead each thread takes
//     ldmatrix.trans of four contiguous 8-row slices of the stage (k rows
//     2t, 2t+1 of each, columns 2c and 2c+1) and byte-permutes them into B
//     fragments of two columns; the k order this gives is the A panel's
//     order too (pj_slot: the quantizer stores each row permuted), and the
//     two columns become two "virtual" n8 blocks. An int32 sum is exact in
//     any order, so the permutations change no bit. A thread then holds
//     the columns 16g + 4t + {0, 1, 2, 3} of each 16-column group g.
// The epilogue works on the registers: one warp holds a whole 64-column
// head, so RoPE's partner of column c < 32 (c + 32) sits in the same
// thread (n8 block j + 4 in bf16, group g + 2 in int8); q is rounded to
// bf16 first, as the TPU kernels do. Stores go straight from registers (4
// or 8 bytes a thread and row).
//
// Requirements (the wrappers check): hd = 64 (a column tile is a head), K
// a multiple of 8 (bf16) or 16 (int8), the o-projection's N a multiple of
// 8 (16), 16-byte aligned bases, and the shared memory of
// proj_smem_bytes() at most PJ_MAX_DSMEM.

#pragma once

#include <cooperative_groups.h>

#include "flash_prefill_core.cuh"
#include "func_attrs.cuh"

namespace {

constexpr int PJ_BN = 64;      // output columns a block: one head
constexpr int PJ_BK = 32;      // weight rows a ring stage
constexpr int PJ_STAGES = 4;
constexpr int PJ_LDB16 = PJ_BN + 8;   // bf16 stage row: 144 bytes, ldmatrix conflict-free
constexpr int PJ_LDB8 = PJ_BN + 16;   // int8 stage row: 80 bytes, conflict-free
constexpr int PJ_MAX_DSMEM = 200 * 1024;

struct ProjArgs {
  const bf16* a;  // (M, K) bf16 rows: x (q/k/v launch) or o (bf16 o launch)
  const signed char* a8;  // int8 o launch: o8 (M, K), per-row int8 of o
  const float* a_scale;   // and its row scales (M)
  const bf16* gamma;  // RMSNorm weight (K), q/k/v launch only
  float eps;
  const void* w[3];        // q/k/v: wq (K, Hq*64), wk, wv (K, Hkv*64); o: w[0] = wo (K, N)
  const bf16* w_scale[3];  // int8: the per-column scales of w[i]
  int heads_q, heads_kv;   // q/k/v: the grid's first heads_q tiles are q, then heads_kv of k, then v
  const bf16* cos;  // (seq, 64) RoPE tables
  const bf16* sin;
  int seq;  // rows a batch: row m is position m % seq of batch m / seq
  bf16* q;  // (M, heads_q * 64)
  bf16* k;  // row s of batch b at b * kv_bstride + s * heads_kv * 64
  bf16* v;
  long long kv_bstride;
  bf16* out;  // o launch: (M, N)
  const bf16* resid;  // o launch: x, (M, N)
  int N;
  int M, K;
};

__host__ __device__ constexpr int pj_kpad(int K) { return (K + PJ_BK - 1) / PJ_BK * PJ_BK; }

// A launch's dynamic shared memory: the bf16 rows (in int8, x staged for
// the q/k/v launch's quantizer), the int8 panel, the weight ring.
inline size_t proj_smem_bytes(int mw, int K, bool int8, bool qkv) {
  const size_t kp = pj_kpad(K), rows = 16 * mw;
  const size_t panel16 = rows * (kp + 8) * 2;
  if (!int8) return panel16 + (size_t)PJ_STAGES * PJ_BK * PJ_LDB16 * 2;
  return (qkv ? panel16 : 0) + rows * (kp + 16) + (size_t)PJ_STAGES * PJ_BK * PJ_LDB8;
}

// The panel position of column k of an int8 row: within each 16 columns,
// k = 2t + i (i < 2) goes to 4t + i and k = 8 + 2t + i to 4t + 2 + i,
// which is the k order of the B fragments the int8 mainloop assembles.
__device__ __forceinline__ int pj_slot(int k) {
  const int k16 = k & 15;
  return (k & ~15) + 4 * ((k16 & 7) >> 1) + 2 * (k16 >> 3) + (k16 & 1);
}

// a / b rounded to nearest (a row's mean square), with 0 for a zero
// numerator without dividing: fp32 division takes its slow path on a zero
// numerator, which every row past M (zeros) would take. The same bits as
// a / b (b is positive and finite).
__device__ __forceinline__ float pj_div(float a, float b) { return a == 0.f ? 0.f : __fdiv_rn(a, b); }

// clip(rint(h / sc), -127, 127), h / sc rounded to nearest as IEEE division
// rounds it, without a division: inv = RN(1 / sc), q = h * inv, and two FMA
// corrections q += (h - sc * q) * inv; the first makes q faithful, and with
// a correctly rounded reciprocal and an exact remainder the second gives
// RN(h / sc) (Markstein's theorem). Nothing can underflow where the
// quotient is near an integer + 1/2 (|h| >= sc / 2 there). A division
// (__fdiv_rn) brings a conditional call to its slow path into the loop,
// which kept the compiler from overlapping the 16 rows.
__device__ __forceinline__ int pj_quant(float h, float sc, float inv) {
  float q = __fmul_rn(h, inv);
  q = __fmaf_rn(__fmaf_rn(-sc, q, h), inv, q);
  q = __fmaf_rn(__fmaf_rn(-sc, q, h), inv, q);
  return min(max(__float2int_rn(q), -127), 127);
}

// gamma[k], gamma[k + 1]: the RMSNorm weight of two neighbouring columns.
__device__ __forceinline__ float2 pj_gamma2(const bf16* gamma, int k) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + k));
}

// Two neighbouring columns of rowquant's fp32 RMSNorm, (x * rs) * gamma,
// not rounded.
__device__ __forceinline__ float2 pj_h2(const bf16* x, float rs, float2 g) {
  float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
  h.x = __fmul_rn(__fmul_rn(h.x, rs), g.x);
  h.y = __fmul_rn(__fmul_rn(h.y, rs), g.y);
  return h;
}

// The sum (MAX = false) or maximum (true) of N values at once, each over
// the W-lane groups of the warp by a butterfly (W = 32: warp_sum's or
// warp_max's), its rounds interleaved.
template <bool MAX, int N, int W>
__device__ __forceinline__ void pj_warp_reduce(float (&v)[N]) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float u = __shfl_xor_sync(0xffffffffu, v[r], o);
      v[r] = MAX ? fmaxf(v[r], u) : v[r] + u;
    }
}

__device__ __forceinline__ void pj_mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One int8 ring stage (32 k rows x 64 columns, row stride PJ_LDB8) into a
// warp's 16 x 64 int32 tile: acc[g][e] is 16-column group g's virtual n8
// block e; a holds the warp's A fragment of the stage (16 rows, 32 panel
// slots). r[i]: k rows 8i + 2 tig, 8i + 2 tig + 1 of columns 16g + 2 gid, + 1,
// byte-permuted into the B fragments of the two virtual blocks.
__device__ __forceinline__ void pj_mma_s8_stage(int (&acc)[4][2][4], const uint32_t (&a)[4],
                                                const signed char* st, int lane) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t r[4];
    fp_ldmatrix_x4_trans(r, reinterpret_cast<const bf16*>(st + lane * PJ_LDB8 + 16 * g));
    pj_mma_s8(acc[g][0], a, __byte_perm(r[0], r[1], 0x6420), __byte_perm(r[2], r[3], 0x6420));
    pj_mma_s8(acc[g][1], a, __byte_perm(r[0], r[1], 0x7531), __byte_perm(r[2], r[3], 0x7531));
  }
}

// 16 int8 values of a row in column order (words k0-3, k4-7, k8-11, k12-15)
// put in the panel's k order (pj_slot): {k0 k1 k8 k9, k2 k3 k10 k11, k4 k5
// k12 k13, k6 k7 k14 k15}.
__device__ __forceinline__ uint4 pj_slot_order16(uint4 u) {
  return make_uint4(__byte_perm(u.x, u.z, 0x5410), __byte_perm(u.x, u.z, 0x7632),
                    __byte_perm(u.y, u.w, 0x5410), __byte_perm(u.y, u.w, 0x7632));
}

// What a block's column tile is: its weight and its column in it, the
// weight's row stride and width, and its epilogue.
enum ProjTileKind { PJ_Q = 0, PJ_K = 1, PJ_V = 2, PJ_O = 3 };

struct ProjTile {
  int kind;
  const void* w;
  const bf16* w_scale;
  int col0;  // first column of the tile in its weight and destination
  int ldw;   // the weight's width (its row stride)
};

__device__ __forceinline__ ProjTile pj_tile(const ProjArgs& p, bool qkv) {
  const int t = blockIdx.x;
  if (!qkv) return {PJ_O, p.w[0], p.w_scale[0], t * PJ_BN, p.N};
  const int wq = p.heads_q * PJ_BN, wkv = p.heads_kv * PJ_BN;
  if (t < p.heads_q) return {PJ_Q, p.w[0], p.w_scale[0], t * PJ_BN, wq};
  if (t < p.heads_q + p.heads_kv) return {PJ_K, p.w[1], p.w_scale[1], (t - p.heads_q) * PJ_BN, wkv};
  return {PJ_V, p.w[2], p.w_scale[2], (t - p.heads_q - p.heads_kv) * PJ_BN, wkv};
}

// Ring stage kt: weight rows [k0 + 32 kt, k0 + 32 kt + 32) x columns
// [col0, col0 + 64), T = bf16 or signed char; zeros past K and past the
// weight's width (whose multiple-of-16-bytes rows keep every chunk whole).
template <typename T, int NT>
__device__ __forceinline__ void pj_issue_stage(T* ring, const ProjTile& tl, int K, int kt, int tid,
                                               int k0 = 0) {
  constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = PJ_BN / EPC;      // chunks a stage row
  constexpr int LD = PJ_BN + EPC;
  T* st = ring + (kt % PJ_STAGES) * PJ_BK * LD;
  const T* w = static_cast<const T*>(tl.w);
#pragma unroll
  for (int e = tid; e < PJ_BK * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * EPC;
    const int gk = k0 + kt * PJ_BK + r, gn = tl.col0 + c;
    const bool valid = gk < K && gn < tl.ldw;
    fp_cp_async16(st + r * LD + c, w + (valid ? (size_t)gk * tl.ldw + gn : 0), valid);
  }
}

// The warp's 16 rows of the (M, K) matrix a of T (bf16 or int8) into
// `rows` (row stride ld elements), zero past M; K * sizeof(T) % 16 == 0.
// The lanes take the rows' 16-byte chunks in turn.
template <typename T>
__device__ __forceinline__ void pj_issue_rows(T* rows, int ld, const T* a, int M, int K, int row0,
                                              int lane) {
  constexpr int EPC = 16 / sizeof(T);
  const int cpr = K / EPC;
  for (int e = lane; e < 16 * cpr; e += 32) {
    const int r = e / cpr, c = (e % cpr) * EPC;
    const bool valid = row0 + r < M;
    fp_cp_async16(rows + r * ld + c, a + (valid ? (size_t)(row0 + r) * K + c : 0), valid);
  }
}

// Row m's destination for the tile's columns.
__device__ __forceinline__ bf16* pj_dst(const ProjArgs& p, const ProjTile& tl, int m) {
  if (tl.kind == PJ_Q) return p.q + (size_t)m * (p.heads_q * PJ_BN) + tl.col0;
  if (tl.kind == PJ_O) return p.out + (size_t)m * p.N + tl.col0;
  bf16* base = tl.kind == PJ_K ? p.k : p.v;
  return base + (size_t)(m / p.seq) * (size_t)p.kv_bstride +
         (size_t)(m % p.seq) * (p.heads_kv * PJ_BN) + tl.col0;
}

// RoPE of one rounded value q at head column ch (< 64) of row m, partner
// value `other` (column ch +- 32): q * cos + rotate_half(q) * sin.
__device__ __forceinline__ float pj_rope(const ProjArgs& p, int m, int ch, float q, float other) {
  const int pos = m % p.seq;
  const float rot = ch < PJ_BN / 2 ? -other : other;
  const float c = bf2f(p.cos[(size_t)pos * PJ_BN + ch]);
  const float s = bf2f(p.sin[(size_t)pos * PJ_BN + ch]);
  return q * c + rot * s;
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// The warp's 16 rows of the (M, K) bf16 matrix a into its whole-row panel
// rows (row stride lda), zero past M and in the columns from K to the
// padded width (the caller commits the copies).
__device__ __forceinline__ void pj_issue_panel(bf16* wrows, int lda, const bf16* a, int M, int K, int row0,
                                               int lane) {
  const int pad = pj_kpad(K) - K;
  pj_issue_rows(wrows, lda, a, M, K, row0, lane);
  for (int e = lane; e < 16 * pad; e += 32) wrows[(e / pad) * lda + K + e % pad] = __float2bfloat16(0.f);
}

// The warp's 16 panel rows normalised in place, each row's arithmetic in
// the header's order:
//   LN = false (RMSNorm):   h = bf16(x * rsqrt(mean(x^2) + eps) * gamma)
//   LN = true (LayerNorm):  h = bf16((x - mu) * rsqrt(var + eps) * gamma + beta)
// That order gives lane l of a row's warp the sum of columns 8 l .. 8 l + 7,
// 8 l + 256 .., and adds the 32 lanes' sums by a butterfly (xor 16, 8, .., 1).
// Where K <= 256 / G the lanes past K / 8 sum nothing, and their exact zeros
// change no partial sum of the butterfly's first log2(G) steps; so each row
// takes 32 / G lanes and G rows go side by side, the butterfly starting at
// xor 16 / G: the same sums with G times fewer instructions. 16 / G rows a
// lane, all at once (independent chains).
template <bool LN, int G>
__device__ __forceinline__ void pj_norm_rows(bf16* wrows, int lda, int K, const bf16* gamma,
                                             const bf16* beta, float eps, int lane) {
  constexpr int NR = 16 / G, LW = 32 / G;
  bf16* rows = wrows + (lane / LW) * lda;  // this lane's row i is rows + G i lda
  const int k0 = (lane % LW) * 8;
  float mu[NR], ss[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) mu[r] = ss[r] = 0.f;
  if constexpr (LN) {
    for (int k = k0; k < K; k += 256) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(rows + G * r * lda + k), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) mu[r] += f[j];
      }
    }
    pj_warp_reduce<false, NR, LW>(mu);
#pragma unroll
    for (int r = 0; r < NR; ++r) mu[r] = pj_div(mu[r], (float)K);
  }
  for (int k = k0; k < K; k += 256) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(rows + G * r * lda + k), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (LN) {
          const float d = f[j] - mu[r];
          ss[r] += d * d;
        } else {
          ss[r] += f[j] * f[j];
        }
      }
    }
  }
  pj_warp_reduce<false, NR, LW>(ss);
#pragma unroll
  for (int r = 0; r < NR; ++r) ss[r] = rsqrtf(pj_div(ss[r], (float)K) + eps);
  for (int k = k0; k < K; k += 256) {
    float g[8], bt[8];
    unpack8(ldg16(gamma + k), g);
    if constexpr (LN) unpack8(ldg16(beta + k), bt);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      bf16* h = rows + G * r * lda + k;
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(h), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (LN) {
          float v = (f[j] - mu[r]) * ss[r] * g[j];
          v += bt[j];
          f[j] = v;
        } else {
          f[j] = f[j] * ss[r] * g[j];
        }
      }
      *reinterpret_cast<uint4*>(h) = pack8(f);
    }
  }
}

// The bf16 mainloop over nk ring stages: acc[b] += the warp's 16 A rows @
// column tile b, for NB column tiles that share the A fragments (ring b
// holds tile b's stages, one after another). `issue(kt)` issues stage kt
// of every tile (and, with STREAM, of the A rows); stages 0 ..
// PJ_STAGES - 2 were issued before, one commit group each. The warp's A
// rows of stage kt are at a0 + kt * PJ_BK (a whole-row panel) or, with
// STREAM, at a0 + (kt % PJ_STAGES) * a_stage (an A ring beside the
// weight's); row stride lda.
template <int NB, bool STREAM, typename Issue>
__device__ __forceinline__ void pj_bf16_mainloop(float (&acc)[NB][PJ_BN / 8][4], const bf16* a0, int lda,
                                                 int a_stage, const bf16* ring, int nk, int lane,
                                                 Issue issue) {
  for (int kt = 0; kt < nk; ++kt) {
    fp_cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    if (kt + PJ_STAGES - 1 < nk) issue(kt + PJ_STAGES - 1);
    fp_cp_async_commit();
    const bf16* at = STREAM ? a0 + (kt % PJ_STAGES) * a_stage : a0 + kt * PJ_BK;
#pragma unroll
    for (int kk = 0; kk < PJ_BK / 16; ++kk) {
      uint32_t a[4];
      fp_ldmatrix_x4(a, at + (lane & 15) * lda + kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const bf16* st = ring + (b * PJ_STAGES + kt % PJ_STAGES) * PJ_BK * PJ_LDB16;
        uint32_t f[PJ_BN / 16][4];
#pragma unroll
        for (int jj = 0; jj < PJ_BN / 16; ++jj)
          fp_ldmatrix_x4_trans(f[jj], st + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * PJ_LDB16 +
                                          16 * jj + 8 * (lane >> 4));
#pragma unroll
        for (int jj = 0; jj < PJ_BN / 16; ++jj) {
          fp_mma(acc[b][2 * jj], a, f[jj][0], f[jj][1]);
          fp_mma(acc[b][2 * jj + 1], a, f[jj][2], f[jj][3]);
        }
      }
    }
  }
  fp_cp_async_wait<0>();
}

template <int MW, bool QKV>
__device__ __forceinline__ void pj_bf16_body(const ProjArgs& p) {
  constexpr int NT = 32 * MW;
  extern __shared__ __align__(128) unsigned char pj_smem[];
  const int kp = pj_kpad(p.K);
  const int lda = kp + 8;
  bf16* panel = reinterpret_cast<bf16*>(pj_smem);
  bf16* ring = panel + 16 * MW * lda;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * 16 * MW + warp * 16;  // the warp's first row
  bf16* wrows = panel + warp * 16 * lda;
  const ProjTile tl = pj_tile(p, QKV);
  const int nk = kp / PJ_BK;

  pj_issue_panel(wrows, lda, p.a, p.M, p.K, row0, lane);
  fp_cp_async_commit();
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < nk) pj_issue_stage<bf16, NT>(ring, tl, p.K, s, tid);
    fp_cp_async_commit();
  }

  if (QKV) {
    // The warp's rows have landed (groups complete in order): normalise
    // them in place.
    fp_cp_async_wait<PJ_STAGES - 1>();
    __syncwarp();
    pj_norm_rows<false, 1>(wrows, lda, p.K, p.gamma, nullptr, p.eps, lane);
  }

  float accs[1][PJ_BN / 8][4];
  auto& acc = accs[0];
#pragma unroll
  for (int j = 0; j < PJ_BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  pj_bf16_mainloop<1, false>(accs, wrows, lda, 0, ring, nk, lane,
                             [&](int kt) { pj_issue_stage<bf16, NT>(ring, tl, p.K, kt, tid); });

  // Epilogue. Thread (gid, tig) holds rows gid, gid + 8 and, in n8 block
  // j, columns 8j + 2 tig + {0, 1}: acc[j][{0, 1}] and acc[j][{2, 3}].
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + gid + 8 * h;
    if (m >= p.M) continue;
    bf16* dst = pj_dst(p, tl, m);
    float o[PJ_BN / 8][2];
    if (tl.kind == PJ_Q || tl.kind == PJ_K) {
      float q[PJ_BN / 8][2];
#pragma unroll
      for (int j = 0; j < PJ_BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) q[j][c] = bf16_round(acc[j][2 * h + c]);
#pragma unroll
      for (int j = 0; j < PJ_BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          o[j][c] = pj_rope(p, m, 8 * j + 2 * tig + c, q[j][c], q[(j + 4) % 8][c]);
    } else if (tl.kind == PJ_V) {
#pragma unroll
      for (int j = 0; j < PJ_BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) o[j][c] = acc[j][2 * h + c];
    } else {
      const bf16* res = p.resid + (size_t)m * p.N + tl.col0;
#pragma unroll
      for (int j = 0; j < PJ_BN / 8; ++j) {
        if (tl.col0 + 8 * j >= p.N) continue;
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + 8 * j + 2 * tig));
        o[j][0] = r.x + bf16_round(acc[j][2 * h]);
        o[j][1] = r.y + bf16_round(acc[j][2 * h + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < PJ_BN / 8; ++j)
      if (tl.kind != PJ_O || tl.col0 + 8 * j < p.N)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * tig) = fp_pack(o[j][0], o[j][1]);
  }
}

template <int MW>
__global__ void __launch_bounds__(32 * MW) qkv_proj_bf16_kernel(ProjArgs p) {
  pj_bf16_body<MW, true>(p);
}

template <int MW>
__global__ void __launch_bounds__(32 * MW) o_proj_bf16_kernel(ProjArgs p) {
  pj_bf16_body<MW, false>(p);
}

// ---------------------------------------------------------------------------
// dense products (#6 fused_mlp_block, #8 swin_block_fused)
// ---------------------------------------------------------------------------
//
// C = prologue(A) @ W for a row-major (M, K) A and (K, N) W, with the
// epilogues of the TPU kernels' products, rounded where they round:
//   PJE_BIAS      out = bf16(acc + bias)
//   PJE_GELU      g = bf16(acc + bias); out = bf16(tanh-GELU(g))
//   PJE_SILU_MUL  two weights W, W2 on the same A fragments:
//                 out = bf16(bf16(silu(acc)) * bf16(acc2))
//   PJE_RESID     out = bf16(resid + bf16(acc + bias))
// (the bias optional where it is named). N and K are multiples of 8; a
// column tile past N is zero-filled in the ring and not stored.
//
// Two bodies, 64-row blocks of four warps:
//   panel (PJE_BIAS, PJE_GELU, PJE_SILU_MUL): a block owns one 64-column
//     tile; its A operand is a whole-row panel formed once, normalised in
//     place (RMSNorm or LayerNorm, pj_norm_rows) where the product has a
//     norm prologue; the weights stream through the ring (two rings for
//     PJE_SILU_MUL);
//   stream (PJE_RESID, no prologue): the A rows stream through a ring of
//     their own beside the weight's, so K (#6's down product: K = 1536) sets
//     no shared-memory size; the K tiles split over a cluster of KS blocks
//     (grid x = column tiles x KS), each block's fp32 partial tile is summed
//     by rank order through distributed shared memory, and each block of the
//     cluster finishes 64 / KS of the rows.

enum PjNorm { PJN_NONE = 0, PJN_RMS = 1, PJN_LN = 2 };
enum PjEpi { PJE_BIAS = 0, PJE_GELU = 1, PJE_SILU_MUL = 2, PJE_RESID = 3 };

constexpr int PJ_LDA = PJ_BK + 8;     // streamed A stage row: 80 bytes, ldmatrix conflict-free
constexpr int PJ_RED_LD = PJ_BN + 4;  // fp32 partial tile row
constexpr int PJ_DENSE_MW = 4;        // warps a dense block: 64 rows

struct DenseArgs {
  const bf16* a;      // (M, K)
  const bf16* gamma;  // norm scale (K)
  const bf16* beta;   // LayerNorm shift (K)
  float eps;
  const bf16* w;      // (K, N)
  const bf16* w2;     // second (K, N) weight, PJE_SILU_MUL
  const bf16* bias;   // (N) or null
  const bf16* resid;  // (M, N), PJE_RESID
  bf16* out;          // (M, N)
  int M, N, K;
};

// Dynamic shared memory of a panel launch (nb weights: the panel and the
// rings) and of a stream launch (the A and weight rings).
inline size_t dense_panel_smem_bytes(int K, int nb) {
  return (size_t)16 * PJ_DENSE_MW * (pj_kpad(K) + 8) * 2 + (size_t)nb * PJ_STAGES * PJ_BK * PJ_LDB16 * 2;
}
constexpr size_t dense_stream_smem_bytes() {
  return (size_t)PJ_STAGES * (16 * PJ_DENSE_MW * PJ_LDA + PJ_BK * PJ_LDB16) * 2;
}

// v[i] += bias[c + i] (nothing where there is no bias).
template <int N>
__device__ __forceinline__ void pj_add_bias(float (&v)[N], const bf16* bias, int c) {
  if (bias == nullptr) return;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] += bf2f(bias[c + i]);
}

__device__ __forceinline__ float pj_silu_mul(float g, float u) {
  return bf16_round(g / (1.f + expf(-g))) * bf16_round(u);
}

__device__ __forceinline__ float pj_gelu(float v) {
  const float g = bf16_round(v);
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

template <int NORM, int EPI>
__device__ __forceinline__ void pj_dense_panel_body(const DenseArgs& p) {
  constexpr int NT = 32 * PJ_DENSE_MW;
  constexpr int NB = EPI == PJE_SILU_MUL ? 2 : 1;
  static_assert(EPI != PJE_RESID, "the residual epilogue is the stream body's");
  extern __shared__ __align__(128) unsigned char pj_smem[];
  const int kp = pj_kpad(p.K);
  const int lda = kp + 8;
  bf16* panel = reinterpret_cast<bf16*>(pj_smem);
  bf16* ring = panel + 16 * PJ_DENSE_MW * lda;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * 16 * PJ_DENSE_MW + warp * 16;
  const int col0 = blockIdx.x * PJ_BN;
  bf16* wrows = panel + warp * 16 * lda;
  const ProjTile tl[2] = {{PJ_O, p.w, nullptr, col0, p.N}, {PJ_O, p.w2, nullptr, col0, p.N}};
  const int nk = kp / PJ_BK;
  auto issue = [&](int kt) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      pj_issue_stage<bf16, NT>(ring + b * PJ_STAGES * PJ_BK * PJ_LDB16, tl[b], p.K, kt, tid);
  };

  pj_issue_panel(wrows, lda, p.a, p.M, p.K, row0, lane);
  fp_cp_async_commit();
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < nk) issue(s);
    fp_cp_async_commit();
  }
  if (NORM != PJN_NONE) {
    fp_cp_async_wait<PJ_STAGES - 1>();
    __syncwarp();
    constexpr bool LN = NORM == PJN_LN;
    if (p.K <= 64)
      pj_norm_rows<LN, 4>(wrows, lda, p.K, p.gamma, p.beta, p.eps, lane);
    else if (p.K <= 128)
      pj_norm_rows<LN, 2>(wrows, lda, p.K, p.gamma, p.beta, p.eps, lane);
    else
      pj_norm_rows<LN, 1>(wrows, lda, p.K, p.gamma, p.beta, p.eps, lane);
  }

  float acc[NB][PJ_BN / 8][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < PJ_BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[b][j][i] = 0.f;
  pj_bf16_mainloop<NB, false>(acc, wrows, lda, 0, ring, nk, lane, issue);

  // Thread (gid, tig) holds rows gid, gid + 8 and, in n8 block j, columns
  // 8j + 2 tig + {0, 1}: acc[.][j][{0, 1}] and acc[.][j][{2, 3}].
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + gid + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < PJ_BN / 8; ++j) {
      const int c = col0 + 8 * j + 2 * tig;
      if (col0 + 8 * j >= p.N) continue;
      float o[2];
      if (EPI == PJE_SILU_MUL) {
#pragma unroll
        for (int i = 0; i < 2; ++i) o[i] = pj_silu_mul(acc[0][j][2 * h + i], acc[NB - 1][j][2 * h + i]);
      } else {
        float v[2] = {acc[0][j][2 * h], acc[0][j][2 * h + 1]};
        pj_add_bias(v, p.bias, c);
#pragma unroll
        for (int i = 0; i < 2; ++i) o[i] = EPI == PJE_GELU ? pj_gelu(v[i]) : v[i];
      }
      *reinterpret_cast<uint32_t*>(p.out + (size_t)m * p.N + c) = fp_pack(o[0], o[1]);
    }
  }
}

// out = bf16(resid + bf16(v + bias)) for N neighbouring columns c.. of row m
// (N = 2 or 4).
template <int N>
__device__ __forceinline__ void pj_resid_store(const DenseArgs& p, int m, int c, float (&v)[N]) {
  pj_add_bias(v, p.bias, c);
  const bf16* r = p.resid + (size_t)m * p.N + c;
  uint32_t o[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 rr = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(r)[i]);
    o[i] = fp_pack(rr.x + bf16_round(v[2 * i]), rr.y + bf16_round(v[2 * i + 1]));
  }
  bf16* dst = p.out + (size_t)m * p.N + c;
  if constexpr (N == 2)
    *reinterpret_cast<uint32_t*>(dst) = o[0];
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
}

template <int KS>
__device__ __forceinline__ void pj_dense_stream_body(const DenseArgs& p) {
  constexpr int NT = 32 * PJ_DENSE_MW, ROWS = 16 * PJ_DENSE_MW;
  constexpr int A_STAGE = ROWS * PJ_LDA;
  extern __shared__ __align__(128) unsigned char pj_smem[];
  bf16* aring = reinterpret_cast<bf16*>(pj_smem);
  bf16* ring = aring + PJ_STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows0 = blockIdx.y * ROWS;  // the block's first row
  const int col0 = (blockIdx.x / KS) * PJ_BN;
  const ProjTile tl = {PJ_O, p.w, nullptr, col0, p.N};
  // This block's K tiles: slice blockIdx.x % KS (its rank in the cluster).
  const int nkt = pj_kpad(p.K) / PJ_BK, per = (nkt + KS - 1) / KS;
  const int kt0 = min(nkt, (int)(blockIdx.x % KS) * per);
  const int nk = min(nkt, kt0 + per) - kt0;
  const int k0 = kt0 * PJ_BK;
  auto issue = [&](int kt) {
    bf16* as = aring + (kt % PJ_STAGES) * A_STAGE;
#pragma unroll
    for (int e = tid; e < ROWS * (PJ_BK / 8); e += NT) {
      const int r = e / (PJ_BK / 8), c = (e % (PJ_BK / 8)) * 8;
      const int gm = rows0 + r, gk = k0 + kt * PJ_BK + c;
      const bool valid = gm < p.M && gk < p.K;
      fp_cp_async16(as + r * PJ_LDA + c, p.a + (valid ? (size_t)gm * p.K + gk : 0), valid);
    }
    pj_issue_stage<bf16, NT>(ring, tl, p.K, kt, tid, k0);
  };
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < nk) issue(s);
    fp_cp_async_commit();
  }

  float acc[1][PJ_BN / 8][4];
#pragma unroll
  for (int j = 0; j < PJ_BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][j][i] = 0.f;
  pj_bf16_mainloop<1, true>(acc, aring + warp * 16 * PJ_LDA, PJ_LDA, A_STAGE, ring, nk, lane, issue);

  if constexpr (KS == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = rows0 + warp * 16 + gid + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < PJ_BN / 8; ++j) {
        if (col0 + 8 * j >= p.N) continue;
        float v[2] = {acc[0][j][2 * h], acc[0][j][2 * h + 1]};
        pj_resid_store(p, m, col0 + 8 * j + 2 * tig, v);
      }
    }
  } else {
    // The partial tile to this block's shared memory (the ring is dead),
    // then each block sums its rows of every block's partial, rank order.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* red = reinterpret_cast<float*>(pj_smem);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < PJ_BN / 8; ++j)
        *reinterpret_cast<float2*>(red + (warp * 16 + gid + 8 * h) * PJ_RED_LD + 8 * j + 2 * tig) =
            make_float2(acc[0][j][2 * h], acc[0][j][2 * h + 1]);
    cluster.sync();
    constexpr int MY_ROWS = ROWS / KS;
    const int rank = (int)cluster.block_rank();
    for (int e = tid; e < MY_ROWS * (PJ_BN / 4); e += NT) {
      const int r = rank * MY_ROWS + e / (PJ_BN / 4), c = (e % (PJ_BN / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const float* part = cluster.map_shared_rank(red, q);
        const float4 t = *reinterpret_cast<const float4*>(part + r * PJ_RED_LD + c);
        v[0] += t.x;
        v[1] += t.y;
        v[2] += t.z;
        v[3] += t.w;
      }
      const int m = rows0 + r;
      if (m < p.M && col0 + c < p.N) pj_resid_store(p, m, col0 + c, v);
    }
    cluster.sync();  // no block leaves while another reads its partial
  }
}

// Sets KERNEL's dynamic shared-memory limit once per device (where the
// launch needs more than the default 48 KB) and launches it on `stream`
// with `cluster` blocks a cluster along x (1: no cluster).
template <auto KERNEL, typename Args>
int pj_launch(const Args& p, dim3 grid, int threads, size_t smem, int cluster, cudaStream_t stream) {
  if (smem > (size_t)PJ_MAX_DSMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    static std::atomic<bool> attrs_set[MELLOW_MAX_DEVICES];
    err = set_func_attrs_once(attrs_set, [&] {
      return cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, PJ_MAX_DSMEM);
    });
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, KERNEL, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// A panel launch: KERNEL a __global__ that runs pj_dense_panel_body with nb
// weights.
template <auto KERNEL>
int launch_dense_panel(const DenseArgs& p, int nb, cudaStream_t stream) {
  const dim3 grid((p.N + PJ_BN - 1) / PJ_BN, (p.M + 63) / 64);
  return pj_launch<KERNEL>(p, grid, 32 * PJ_DENSE_MW, dense_panel_smem_bytes(p.K, nb), 1, stream);
}

// The K split of a stream launch (#7's int8 down product takes it too):
// the largest of 1, 2, 4 and 8 that keeps
// the grid within 528 blocks (4 an SM on an H100's 132) and gives each
// block at least 3 K tiles. KS = 1 is the A rows streamed beside the weight
// alone; a larger KS adds the split over a cluster. Device time a launch
// (torch.profiler; NVIDIA H100 80GB HBM3, 700 W; development runs of this
// design with the split forced) for KS = 1 / 2 / 4 / 8: #6's down product
// (K = 1536) at B=1 (63 column x row tiles) 0.0304 / 0.0148 / 0.0114 /
// 0.0109 ms, at B=4 (225 tiles) 0.0337 / 0.0247 / 0.0308 / 0.0346; #8's
// fc2 at v0 stage 3, B=1 (24 tiles, K = 1536) 0.0300 / 0.0150 / 0.0089 /
// 0.0075, at stage 1, B=4 (512 tiles, K = 384) 0.0186 / 0.0229 / 0.0275 /
// 0.0408. The rule picks the fastest in each of these, and in 16 of the 18
// stream launches of that sweep (v0 stages 1-3 and HTSAT-large stage 1 at
// B=1 and 4); the other two (fc2 at stages 1 and 2, B=1) lose 0.0009-0.0010.
inline int dense_split(int M, int N, int K) {
  const int tiles = (N + PJ_BN - 1) / PJ_BN * ((M + 63) / 64), nkt = pj_kpad(K) / PJ_BK;
  int ks = 8;
  while (ks > 1 && (tiles * ks > 528 || nkt < 3 * ks)) ks /= 2;
  return ks;
}

// A stream launch at dense_split's K split: KERNEL_OF<KS>() the __global__
// that runs pj_dense_stream_body<KS>.
template <template <int> class KERNEL_OF>
int launch_dense_stream(const DenseArgs& p, cudaStream_t stream) {
  const int ks = dense_split(p.M, p.N, p.K);
  const dim3 grid((p.N + PJ_BN - 1) / PJ_BN * ks, (p.M + 63) / 64);
  const int nt = 32 * PJ_DENSE_MW;
  const size_t smem = dense_stream_smem_bytes();
  switch (ks) {
    case 1: return pj_launch<KERNEL_OF<1>::value>(p, grid, nt, smem, 1, stream);
    case 2: return pj_launch<KERNEL_OF<2>::value>(p, grid, nt, smem, 2, stream);
    case 4: return pj_launch<KERNEL_OF<4>::value>(p, grid, nt, smem, 4, stream);
    default: return pj_launch<KERNEL_OF<8>::value>(p, grid, nt, smem, 8, stream);
  }
}

// ---------------------------------------------------------------------------
// int8
// ---------------------------------------------------------------------------

// The q/k/v launch's int8 rows (and #7's): NR bf16 rows x (row stride lds)
// -> the fp32 RMSNorm, not rounded -> per-row int8 into q8 (row stride ld8,
// each row in pj_slot order, zero past K up to the padded width) and the
// row scales, a warp's NR rows at once (NR independent chains); rows past M
// are zeros and quantize to zeros. The sum of squares keeps rowquant_kernel's
// order (lane l sums columns l, l + 32, ..., then warp_sum); the max and
// the quantizer are order-free and take column pairs.
template <int NR = 16>
__device__ __forceinline__ void pj_quantize_rows(const bf16* x, int lds, signed char* q8, int ld8,
                                                 int K, const bf16* gamma, float eps, int lane,
                                                 float* row_scale) {
  float rs[NR], sc[NR], inv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) rs[r] = 0.f;
  for (int k = lane; k < K; k += 32) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float v = bf2f(x[r * lds + k]);
      rs[r] += v * v;
    }
  }
  pj_warp_reduce<false, NR, 32>(rs);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    rs[r] = rsqrtf(pj_div(rs[r], (float)K) + eps);
    sc[r] = 0.f;
  }
  for (int k = 2 * lane; k < K; k += 64) {
    const float2 g = pj_gamma2(gamma, k);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float2 h = pj_h2(x + r * lds + k, rs[r], g);
      sc[r] = fmaxf(sc[r], fmaxf(fabsf(h.x), fabsf(h.y)));
    }
  }
  pj_warp_reduce<true, NR, 32>(sc);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    sc[r] = __fmul_rn(fmaxf(sc[r], 1e-8f), 1.f / 127.f);
    inv[r] = __frcp_rn(sc[r]);
  }
  for (int k = 2 * lane; k < K; k += 64) {
    const int slot = pj_slot(k);  // columns k, k + 1 stay neighbours
    const float2 g = pj_gamma2(gamma, k);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float2 h = pj_h2(x + r * lds + k, rs[r], g);
      const unsigned int q2 =
          (pj_quant(h.x, sc[r], inv[r]) & 0xff) | (pj_quant(h.y, sc[r], inv[r]) & 0xff) << 8;
      *reinterpret_cast<unsigned short*>(q8 + r * ld8 + slot) = (unsigned short)q2;
    }
  }
  for (int k = K + 2 * lane; k < pj_kpad(K); k += 64)  // zeros up to the padded width
#pragma unroll
    for (int r = 0; r < NR; ++r) *reinterpret_cast<unsigned short*>(q8 + r * ld8 + pj_slot(k)) = 0;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r) row_scale[r] = sc[r];
  }
}

template <int MW, bool QKV>
__device__ __forceinline__ void pj_int8_body(const ProjArgs& p) {
  constexpr int NT = 32 * MW;
  extern __shared__ __align__(128) unsigned char pj_smem[];
  __shared__ float row_scale[16 * MW];
  __shared__ __align__(16) bf16 col_scale[PJ_BN];
  const int kp = pj_kpad(p.K);
  const int lds = kp + 8;   // bf16 staging row (elements), q/k/v launch
  const int ld8 = kp + 16;  // int8 panel row (bytes)
  bf16* stage = reinterpret_cast<bf16*>(pj_smem);
  signed char* panel = reinterpret_cast<signed char*>(QKV ? stage + 16 * MW * lds : stage);
  signed char* ring = panel + 16 * MW * ld8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * 16 * MW + warp * 16;
  bf16* wstage = stage + warp * 16 * lds;
  signed char* wpanel = panel + warp * 16 * ld8;
  const ProjTile tl = pj_tile(p, QKV);
  const int nk = kp / PJ_BK;

  if (QKV) {
    pj_issue_rows(wstage, lds, p.a, p.M, p.K, row0, lane);
  } else {
    // o8's rows as they are (K = H * 64, no padding), zero past M.
    pj_issue_rows(wpanel, ld8, p.a8, p.M, p.K, row0, lane);
  }
  if (tid < PJ_BN / 8) {  // the tile's per-column weight scales, zero past its width
    const bool valid = tl.col0 + 8 * tid < tl.ldw;
    fp_cp_async16(col_scale + 8 * tid, tl.w_scale + (valid ? tl.col0 + 8 * tid : 0), valid);
  }
  fp_cp_async_commit();
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < nk) pj_issue_stage<signed char, NT>(ring, tl, p.K, s, tid);
    fp_cp_async_commit();
  }
  if (!QKV && lane < 16) row_scale[warp * 16 + lane] = row0 + lane < p.M ? p.a_scale[row0 + lane] : 0.f;

  fp_cp_async_wait<PJ_STAGES - 1>();
  __syncwarp();
  if (QKV) {
    pj_quantize_rows(wstage, lds, wpanel, ld8, p.K, p.gamma, p.eps, lane, row_scale + warp * 16);
  } else {
    // Put each 16-byte chunk of o8 in the panel's k order.
    for (int e = lane; e < 16 * (p.K / 16); e += 32) {
      uint4* c = reinterpret_cast<uint4*>(wpanel + (e / (p.K / 16)) * ld8 + (e % (p.K / 16)) * 16);
      *c = pj_slot_order16(*c);
    }
  }

  int acc[PJ_BN / 16][2][4];  // [16-column group][virtual n8 block][fragment]
#pragma unroll
  for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][e][i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    fp_cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    if (kt + PJ_STAGES - 1 < nk) pj_issue_stage<signed char, NT>(ring, tl, p.K, kt + PJ_STAGES - 1, tid);
    fp_cp_async_commit();
    const signed char* st = ring + (kt % PJ_STAGES) * PJ_BK * PJ_LDB8;
    uint32_t a[4];  // rows gid (+8), panel slots 4 tig.. (+16)
    fp_ldmatrix_x4(a, reinterpret_cast<const bf16*>(wpanel + (lane & 15) * ld8 + kt * PJ_BK +
                                                     16 * (lane >> 4)));
    pj_mma_s8_stage(acc, a, st, lane);
  }
  fp_cp_async_wait<0>();

  // Epilogue: v = float(C) * row_scale * col_scale. Thread (gid, tig) holds
  // rows gid, gid + 8 and, in group g, columns 16g + 4 tig + c for c = 0..3:
  // acc[g][c & 1][(c >> 1) + 2h] for row gid + 8h.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + gid + 8 * h;
    if (m >= p.M) continue;
    bf16* dst = pj_dst(p, tl, m);
    const float rsc = row_scale[warp * 16 + gid + 8 * h];
    float v[PJ_BN / 16][4];
#pragma unroll
    for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tl.col0 + 16 * g + 4 * tig + c;
        v[g][c] = tl.kind == PJ_O && col >= p.N
                      ? 0.f
                      : __fmul_rn(__fmul_rn((float)acc[g][c & 1][(c >> 1) + 2 * h], rsc),
                                  bf2f(col_scale[16 * g + 4 * tig + c]));
      }
    float o[PJ_BN / 16][4];
    if (tl.kind == PJ_Q || tl.kind == PJ_K) {
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[g][c] = bf16_round(v[g][c]);
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[g][c] = pj_rope(p, m, 16 * g + 4 * tig + c, v[g][c], v[(g + 2) % 4][c]);
    } else if (tl.kind == PJ_V) {
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[g][c] = v[g][c];
    } else {
      const bf16* res = p.resid + (size_t)m * p.N + tl.col0;
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g) {
        if (tl.col0 + 16 * g >= p.N) continue;
        const uint2 u = *reinterpret_cast<const uint2*>(res + 16 * g + 4 * tig);
        const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        o[g][0] = r0.x + bf16_round(v[g][0]);
        o[g][1] = r0.y + bf16_round(v[g][1]);
        o[g][2] = r1.x + bf16_round(v[g][2]);
        o[g][3] = r1.y + bf16_round(v[g][3]);
      }
    }
#pragma unroll
    for (int g = 0; g < PJ_BN / 16; ++g)
      if (tl.kind != PJ_O || tl.col0 + 16 * g < p.N)
        *reinterpret_cast<uint2*>(dst + 16 * g + 4 * tig) =
            make_uint2(fp_pack(o[g][0], o[g][1]), fp_pack(o[g][2], o[g][3]));
  }
}

template <int MW>
__global__ void __launch_bounds__(32 * MW) qkv_proj_int8_kernel(ProjArgs p) {
  pj_int8_body<MW, true>(p);
}

template <int MW>
__global__ void __launch_bounds__(32 * MW) o_proj_int8_kernel(ProjArgs p) {
  pj_int8_body<MW, false>(p);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int MW, bool INT8, bool QKV>
constexpr auto pj_kernel() {
  if constexpr (INT8) {
    if constexpr (QKV) return &qkv_proj_int8_kernel<MW>;
    else return &o_proj_int8_kernel<MW>;
  } else {
    if constexpr (QKV) return &qkv_proj_bf16_kernel<MW>;
    else return &o_proj_bf16_kernel<MW>;
  }
}

// One projection launch: q/k/v (QKV, heads_q + 2 heads_kv column tiles) or
// the o-projection (N / 64 tiles, rounded up). Rows a block, by device
// time of the whole chain at v0 (S=389) on an NVIDIA H100 80GB HBM3 at
// 700 W: bf16 64 (MW = 4): 0.0461 ms against 0.0466 for 32 rows at B=1,
// 0.0806 against 0.0831 at B=4; int8 32 (MW = 2): 0.1049 against 0.1192
// at B=4 (its q/k/v blocks stage x as well, so 64-row blocks fit one an
// SM), 0.0630 against 0.0627 at B=1.
template <bool INT8, bool QKV>
int launch_proj(const ProjArgs& p, cudaStream_t stream) {
  constexpr int MW = INT8 ? 2 : 4;
  const int tiles = QKV ? p.heads_q + 2 * p.heads_kv : (p.N + PJ_BN - 1) / PJ_BN;
  const dim3 grid(tiles, (p.M + 16 * MW - 1) / (16 * MW));
  return pj_launch<pj_kernel<MW, INT8, QKV>()>(p, grid, 32 * MW, proj_smem_bytes(MW, p.K, INT8, QKV), 1,
                                               stream);
}

}  // namespace
