// The W8A8 prefill MLP half of a Llama layer for Hopper (sm_90a).
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_mlp_block.py
// (fused_mlp_block_w8a8, body _kernel_w8a8): fp32 RMSNorm, then per-row
// int8 activations (_rowquant); int8 gate and up products with int32 sums;
// silu(gate * hs * sg) * (up * hs * su) in fp32; per-row int8 of that
// product over I; the int8 down product times its row and column scales,
// rounded to bf16; the residual.
//
// Contract: x (M, D) bf16 with M = B*S rows; ln (D) bf16; w_gate and w_up
// (D, I), w_down (I, D) int8 with per-column bf16 scales sg, su, sd;
// scratch p8 (M, I) int8 and ps (M) fp32; out (M, D) bf16. D and I are
// multiples of 16; the gate/up launch's shared memory
// (w8_gate_up_smem_bytes) is at most PJ_MAX_DSMEM.
//
// What bounds it: at the v0 prefill (M=389, D=576, I=1536) the block is
// 2.06 G int8 operations against 2.65 MB of int8 weights: ~1 us at the
// card's int8 tensor-core peak and ~0.8 us of HBM reads, so on paper
// compute and bytes are close; what a call pays is the latency of each
// block's chain of steps (a ring stage of the mainloop reads ~0.6 us,
// quantizing 32 rows ~15 us: clock64 stamps, PERF.md section 6) and of two
// dependent launches.
//
// What the design does about it: two launches on proj_mma_core.cuh's int8
// path (mma.sync m16n8k32 with exact int32 sums, the weights through the
// cp.async ring, the ldmatrix.trans byte-permute B fragments):
//   1. gate/up and both quantizers: a cluster of W8_CLUSTER blocks shares
//      one block of 32 rows, each block w8_tiles(I) = 3 of the 24 column
//      tiles of I, all three at once (two warps a tile, gate's and up's
//      rings for each). The cluster quantizes the rows once: each block 4 of
//      them (pj_quantize_rows: rowquant_kernel's arithmetic, so h8 and hs are
//      its bits and never reach device memory), written into every block's
//      panel through distributed shared memory. Gate and up accumulate side
//      by side on the same A fragments; the epilogue forms
//      v = float(C) * hs * s and prod = silu(v_g) * v_u in fp32, not
//      rounded, in registers, and parks prod in shared memory. The row max
//      of prod spans all I columns: the blocks' row maxima are exchanged
//      through distributed shared memory, and each block quantizes its own
//      columns (pj_quant: rowquant_kernel's bits) into p8, stored in the
//      down launch's k order (pj_slot); rank 0 stores ps. The (M, I) fp32
//      product never reaches device memory;
//   2. out = bf16(x + bf16(float(p8 @ w_down) * ps * sd)), K = I = 1536:
//      the p8 rows stream through a ring beside the weight's, the K tiles
//      split over a cluster by dense_split, and the int32 partial tiles are
//      summed through distributed shared memory.
// Every sum is an exact int32 sum and every quantizer is rowquant_kernel's
// arithmetic, so the output is that of the four-launch chain this replaced
// (two row quantizers around two wmma GEMMs), bit for bit.

#include "proj_mma_core.cuh"

namespace {

struct MlpW8A8Args {
  const bf16* x;      // (M, D)
  const bf16* gamma;  // RMSNorm weight (D)
  float eps;
  const signed char* wg;  // (D, I)
  const signed char* wu;  // (D, I)
  const bf16* sg;         // (I)
  const bf16* su;         // (I)
  signed char* p8;        // (M, I), each 16 columns in pj_slot order
  float* ps;              // (M)
  const signed char* wd;  // (I, D)
  const bf16* sd;         // (D)
  bf16* out;              // (M, D)
  int M, D, I;
};

constexpr int W8_ROWS = 32;     // gate/up: rows a block (and a cluster)
constexpr int W8_CLUSTER = 8;   // gate/up: blocks sharing a row block
constexpr int W8_QROWS = W8_ROWS / W8_CLUSTER;  // rows each block quantizes for the cluster
constexpr int W8_MAX_NTC = 4;   // gate/up: column tiles a block works on at once
constexpr int W8_RING = PJ_STAGES * PJ_BK * PJ_LDB8;  // one weight's int8 ring
constexpr int W8_A_LD = PJ_BK + 16;    // down: streamed int8 A stage row, 48 bytes, ldmatrix conflict-free
constexpr int W8_RED_LD = PJ_BN + 16;  // down: int32 partial tile row (64 bytes apart a row pair)

// A gate/up block's column tiles, and how many it works on at once: all of
// them up to W8_MAX_NTC. Device time of the chain at v0 (NVIDIA H100 80GB
// HBM3, 700 W; development runs with the count forced) working on 1 / 2 / 3
// of its 3 tiles at once: B=1 0.0706 / 0.0531 / 0.0408 ms, B=4 0.1278 /
// 0.1112 / 0.0863 (one tile at once fits 3 blocks an SM, and still loses).
__host__ __device__ inline int w8_tiles(int I) { return ((I + PJ_BN - 1) / PJ_BN + W8_CLUSTER - 1) / W8_CLUSTER; }
inline int w8_ntc(int I) { return w8_tiles(I) < W8_MAX_NTC ? w8_tiles(I) : W8_MAX_NTC; }

// The fp32 product's row stride in shared memory: 16 mod 32 floats, so
// the epilogue's float4 stores of rows gid and gid + 1 take both halves of
// the banks.
__host__ __device__ inline int w8_prod_ld(int tiles) { return tiles * PJ_BN + 16; }

// The gate/up launch's dynamic shared memory: the fp32 product of the
// block's tiles, the bf16 x rows it quantizes, the int8 panel, gate's and up's
// rings for each tile worked on at once, the tiles' column scales.
inline size_t w8_gate_up_smem_bytes(int D, int I) {
  const size_t kp = pj_kpad(D), t = w8_tiles(I);
  return W8_ROWS * w8_prod_ld(t) * 4 + W8_QROWS * (kp + 8) * 2 + W8_ROWS * (kp + 16) +
         2 * (size_t)w8_ntc(I) * W8_RING + 2 * t * PJ_BN * 2;
}

__device__ __forceinline__ float w8_silu(float v) { return v / (1.f + expf(-v)); }

template <int NTC>
__global__ void __launch_bounds__(64 * NTC) mlp_w8a8_gate_up_kernel(MlpW8A8Args p) {
  namespace cg = cooperative_groups;
  constexpr int NT = 64 * NTC, NW = 2 * NTC;
  extern __shared__ __align__(128) unsigned char pj_smem[];
  __shared__ float row_scale[W8_ROWS], part_max[NTC][W8_ROWS], peer_max[W8_CLUSTER][W8_ROWS];
  cg::cluster_group cluster = cg::this_cluster();
  const int kp = pj_kpad(p.D), lds = kp + 8, ld8 = kp + 16, nk = kp / PJ_BK;
  const int T = w8_tiles(p.I), pld = w8_prod_ld(T);
  float* prod = reinterpret_cast<float*>(pj_smem);
  bf16* xs = reinterpret_cast<bf16*>(prod + W8_ROWS * pld);
  signed char* panel = reinterpret_cast<signed char*>(xs + W8_QROWS * lds);
  signed char* rings = panel + W8_ROWS * ld8;  // tile slot j: gate's ring 2j, up's 2j + 1
  bf16* scales = reinterpret_cast<bf16*>(rings + 2 * NTC * W8_RING);  // sg, then su, of the block's tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int slot = warp / 2, half = warp % 2;  // the warp's tile slot and its 16 rows
  const int rank = (int)cluster.block_rank(), rows0 = blockIdx.y * W8_ROWS;
  const int ntiles = (p.I + PJ_BN - 1) / PJ_BN;
  const int t0 = min(ntiles, rank * T), nt = min(ntiles, t0 + T) - t0;  // this block's column tiles
  const int total = (nt + NTC - 1) / NTC * nk;  // stages: nk a round of NTC tiles

  // The cluster's rows rank * W8_QROWS.. of x, and the block's column scales
  // (zero past I).
  for (int e = tid; e < W8_QROWS * (p.D / 8); e += NT) {
    const int r = e / (p.D / 8), c = (e % (p.D / 8)) * 8, m = rows0 + rank * W8_QROWS + r;
    fp_cp_async16(xs + r * lds + c, p.x + (m < p.M ? (size_t)m * p.D + c : 0), m < p.M);
  }
  for (int e = tid; e < 2 * nt * (PJ_BN / 8); e += NT) {
    const int w = e / (nt * (PJ_BN / 8)), c = (e % (nt * (PJ_BN / 8))) * 8, gc = t0 * PJ_BN + c;
    fp_cp_async16(scales + w * T * PJ_BN + c, (w ? p.su : p.sg) + (gc < p.I ? gc : 0), gc < p.I);
  }
  fp_cp_async_commit();
  // Stage s: K tile s % nk of the round s / nk's NTC column tiles, gate's
  // and up's, in ring slot s % PJ_STAGES; zeros past the block's tiles, D and I.
  auto issue = [&](int s) {
    const int round = s / nk, kf = (s % nk) * PJ_BK;
#pragma unroll
    for (int e = tid; e < NTC * 2 * PJ_BK * (PJ_BN / 16); e += NT) {
      const int j = e / (2 * PJ_BK * (PJ_BN / 16)), w = e / (PJ_BK * (PJ_BN / 16)) % 2;
      const int r = e / (PJ_BN / 16) % PJ_BK, c = e % (PJ_BN / 16) * 16;
      const int col = (t0 + round * NTC + j) * PJ_BN + c, gk = kf + r;
      const bool valid = round * NTC + j < nt && gk < p.D && col < p.I;
      fp_cp_async16(rings + (2 * j + w) * W8_RING + ((s % PJ_STAGES) * PJ_BK + r) * PJ_LDB8 + c,
                    (w ? p.wu : p.wg) + (valid ? (size_t)gk * p.I + col : 0), valid);
    }
  };
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < total) issue(s);
    fp_cp_async_commit();
  }
  // Every block of the cluster runs before any writes into another's panel.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  fp_cp_async_wait<PJ_STAGES - 1>();
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
  // Quantize this block's share of the rows into its panel, then copy each
  // int8 row and its scale into the other blocks' panels.
  for (int r = warp; r < W8_QROWS; r += NW) {
    const int row = rank * W8_QROWS + r;
    pj_quantize_rows<1>(xs + r * lds, lds, panel + row * ld8, ld8, p.D, p.gamma, p.eps, lane, row_scale + row);
    __syncwarp();
    const uint4* src = reinterpret_cast<const uint4*>(panel + row * ld8);
    for (int e = lane; e < (W8_CLUSTER - 1) * (kp / 16); e += 32) {
      const int q = (rank + 1 + e / (kp / 16)) % W8_CLUSTER, c = e % (kp / 16);
      reinterpret_cast<uint4*>(cluster.map_shared_rank(panel, q) + row * ld8)[c] = src[c];
    }
    if (lane < W8_CLUSTER) cluster.map_shared_rank(row_scale, lane)[row] = row_scale[row];
  }
  cluster.sync();  // every panel holds all the rows

  int acc[2][PJ_BN / 16][2][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[b][g][e][i] = 0;
  float pmax[2] = {0.f, 0.f};
  const int wrow = half * 16;  // the warp's first row in the block
  const float rsc[2] = {row_scale[wrow + gid], row_scale[wrow + gid + 8]};
  const signed char* wpanel = panel + wrow * ld8;
  const signed char* ring_g = rings + 2 * slot * W8_RING;
  const signed char* ring_u = ring_g + W8_RING;

  for (int s = 0; s < total; ++s) {
    fp_cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    if (s + PJ_STAGES - 1 < total) issue(s + PJ_STAGES - 1);
    fp_cp_async_commit();
    const int kt = s % nk, tl = s / nk * NTC + slot;  // the warp's tile among the block's
    if (tl >= nt) continue;
    uint32_t a[4];
    fp_ldmatrix_x4(a, reinterpret_cast<const bf16*>(wpanel + (lane & 15) * ld8 + kt * PJ_BK + 16 * (lane >> 4)));
    pj_mma_s8_stage(acc[0], a, ring_g + (s % PJ_STAGES) * PJ_BK * PJ_LDB8, lane);
    pj_mma_s8_stage(acc[1], a, ring_u + (s % PJ_STAGES) * PJ_BK * PJ_LDB8, lane);
    if (kt != nk - 1) continue;
    // Column tile done. Thread (gid, tig) holds rows gid, gid + 8 and, in
    // group g, columns 16g + 4 tig + c: acc[.][g][c & 1][(c >> 1) + 2h].
    const bf16* sg = scales + tl * PJ_BN;
    const bf16* su = scales + T * PJ_BN + tl * PJ_BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g) {
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 16 * g + 4 * tig + c;
          const float vg = __fmul_rn(__fmul_rn((float)acc[0][g][c & 1][(c >> 1) + 2 * h], rsc[h]), bf2f(sg[col]));
          const float vu = __fmul_rn(__fmul_rn((float)acc[1][g][c & 1][(c >> 1) + 2 * h], rsc[h]), bf2f(su[col]));
          o[c] = __fmul_rn(w8_silu(vg), vu);
          pmax[h] = fmaxf(pmax[h], fabsf(o[c]));
        }
        *reinterpret_cast<float4*>(prod + (wrow + gid + 8 * h) * pld + tl * PJ_BN + 16 * g + 4 * tig) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[b][g][e][i] = 0;
  }
  fp_cp_async_wait<0>();

  // The row maxima of prod: the four lanes of a row, the block's tile
  // slots, then the cluster's blocks (each block stores its maxima into
  // every block's peer_max, so all reads are local); the scale as
  // rowquant_kernel forms it.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pmax[h] = fmaxf(pmax[h], __shfl_xor_sync(0xffffffffu, pmax[h], 1));
    pmax[h] = fmaxf(pmax[h], __shfl_xor_sync(0xffffffffu, pmax[h], 2));
    if (tig == 0) part_max[slot][wrow + gid + 8 * h] = pmax[h];
  }
  __syncthreads();
  for (int e = tid; e < W8_ROWS * W8_CLUSTER; e += NT) {
    const int r = e % W8_ROWS;
    float m = part_max[0][r];
#pragma unroll
    for (int j = 1; j < NTC; ++j) m = fmaxf(m, part_max[j][r]);
    cluster.map_shared_rank(&peer_max[rank][0], e / W8_ROWS)[r] = m;
  }
  cluster.sync();  // the last access to another block's shared memory
  if (tid < W8_ROWS) {
    float m = peer_max[0][tid];
#pragma unroll
    for (int q = 1; q < W8_CLUSTER; ++q) m = fmaxf(m, peer_max[q][tid]);
    const float sc = __fmul_rn(fmaxf(m, 1e-8f), 1.f / 127.f);
    row_scale[tid] = sc;
    if (rank == 0 && rows0 + tid < p.M) p.ps[rows0 + tid] = sc;
  }
  __syncthreads();

  // p8 = clip(rint(prod / sc), -127, 127), 16 columns a thread, stored in
  // pj_slot order.
  const int chunks = nt * (PJ_BN / 16);
  for (int e = tid; e < W8_ROWS * chunks; e += NT) {
    const int r = e / chunks, c = (e % chunks) * 16, m = rows0 + r, col = t0 * PJ_BN + c;
    if (m >= p.M || col >= p.I) continue;
    const float sc = row_scale[r], inv = __frcp_rn(sc);
    const float* v = prod + r * pld + c;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(v + 4 * i);
      w[i] = (pj_quant(f.x, sc, inv) & 0xff) | (pj_quant(f.y, sc, inv) & 0xff) << 8 |
             (pj_quant(f.z, sc, inv) & 0xff) << 16 | (uint32_t)(pj_quant(f.w, sc, inv) & 0xff) << 24;
    }
    *reinterpret_cast<uint4*>(p.p8 + (size_t)m * p.I + col) = pj_slot_order16(make_uint4(w[0], w[1], w[2], w[3]));
  }
}

template <int NTC>
struct MlpW8A8GateUp {
  static constexpr auto value = &mlp_w8a8_gate_up_kernel<NTC>;
};

// out = bf16(x + bf16(float(p8 @ wd) * ps * sd)): p8's rows stream through
// an A ring (already in pj_slot order) beside the weight's; K tiles split
// over a cluster of KS blocks as in pj_dense_stream_body, the int32
// partials summed through distributed shared memory.
template <int KS>
__global__ void __launch_bounds__(128) mlp_w8a8_down_kernel(MlpW8A8Args p) {
  constexpr int NT = 128, ROWS = 64, A_STAGE = ROWS * W8_A_LD;
  extern __shared__ __align__(128) unsigned char pj_smem[];
  __shared__ float row_scale[ROWS];
  __shared__ __align__(16) bf16 col_scale[PJ_BN];
  signed char* aring = reinterpret_cast<signed char*>(pj_smem);
  signed char* ring = aring + PJ_STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows0 = blockIdx.y * ROWS;
  const int col0 = (blockIdx.x / KS) * PJ_BN;
  const ProjTile tl = {PJ_O, p.wd, p.sd, col0, p.D};
  const int nkt = pj_kpad(p.I) / PJ_BK, per = (nkt + KS - 1) / KS;
  const int kt0 = min(nkt, (int)(blockIdx.x % KS) * per);
  const int nk = min(nkt, kt0 + per) - kt0;
  const int k0 = kt0 * PJ_BK;
  auto issue = [&](int kt) {
    signed char* as = aring + (kt % PJ_STAGES) * A_STAGE;
    {
      const int r = tid / 2, c = (tid % 2) * 16;  // 64 rows x 2 chunks: one a thread
      const int gm = rows0 + r, gk = k0 + kt * PJ_BK + c;
      const bool valid = gm < p.M && gk < p.I;
      fp_cp_async16(as + r * W8_A_LD + c, p.p8 + (valid ? (size_t)gm * p.I + gk : 0), valid);
    }
    pj_issue_stage<signed char, NT>(ring, tl, p.I, kt, tid, k0);
  };
  if (tid < PJ_BN / 8) {
    const bool valid = col0 + 8 * tid < p.D;
    fp_cp_async16(col_scale + 8 * tid, p.sd + (valid ? col0 + 8 * tid : 0), valid);
  }
  for (int s = 0; s < PJ_STAGES - 1; ++s) {
    if (s < nk) issue(s);
    fp_cp_async_commit();
  }
  if (tid < ROWS) row_scale[tid] = rows0 + tid < p.M ? p.ps[rows0 + tid] : 0.f;

  int acc[PJ_BN / 16][2][4];
#pragma unroll
  for (int g = 0; g < PJ_BN / 16; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][e][i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    fp_cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    if (kt + PJ_STAGES - 1 < nk) issue(kt + PJ_STAGES - 1);
    fp_cp_async_commit();
    uint32_t a[4];
    fp_ldmatrix_x4(a, reinterpret_cast<const bf16*>(aring + (kt % PJ_STAGES) * A_STAGE +
                                                     (warp * 16 + (lane & 15)) * W8_A_LD + 16 * (lane >> 4)));
    pj_mma_s8_stage(acc, a, ring + (kt % PJ_STAGES) * PJ_BK * PJ_LDB8, lane);
  }
  fp_cp_async_wait<0>();
  __syncthreads();  // row_scale, col_scale; the rings are dead

  // out for 4 neighbouring columns c.. of tile row r from their int32 sums.
  auto store4 = [&](int r, int c, const int (&v)[4]) {
    const int m = rows0 + r;
    if (m >= p.M || col0 + c >= p.D) return;
    const float rs = row_scale[r];
    const bf16* res = p.x + (size_t)m * p.D + col0 + c;
    const uint2 u = *reinterpret_cast<const uint2*>(res);
    const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = bf16_round(__fmul_rn(__fmul_rn((float)v[i], rs), bf2f(col_scale[c + i])));
    *reinterpret_cast<uint2*>(p.out + (size_t)m * p.D + col0 + c) =
        make_uint2(fp_pack(r0.x + y[0], r0.y + y[1]), fp_pack(r1.x + y[2], r1.y + y[3]));
  };

  if constexpr (KS == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g) {
        const int v[4] = {acc[g][0][2 * h], acc[g][1][2 * h], acc[g][0][2 * h + 1], acc[g][1][2 * h + 1]};
        store4(warp * 16 + gid + 8 * h, 16 * g + 4 * tig, v);
      }
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    int* red = reinterpret_cast<int*>(pj_smem);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < PJ_BN / 16; ++g)
        *reinterpret_cast<int4*>(red + (warp * 16 + gid + 8 * h) * W8_RED_LD + 16 * g + 4 * tig) =
            make_int4(acc[g][0][2 * h], acc[g][1][2 * h], acc[g][0][2 * h + 1], acc[g][1][2 * h + 1]);
    cluster.sync();
    constexpr int MY_ROWS = ROWS / KS;
    const int rank = (int)cluster.block_rank();
    for (int e = tid; e < MY_ROWS * (PJ_BN / 4); e += NT) {
      const int r = rank * MY_ROWS + e / (PJ_BN / 4), c = (e % (PJ_BN / 4)) * 4;
      int v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const int4 t = *reinterpret_cast<const int4*>(cluster.map_shared_rank(red, q) + r * W8_RED_LD + c);
        v[0] += t.x;
        v[1] += t.y;
        v[2] += t.z;
        v[3] += t.w;
      }
      store4(r, c, v);
    }
    cluster.sync();  // no block leaves while another reads its partial
  }
}

template <int KS>
struct MlpW8A8Down {
  static constexpr auto value = &mlp_w8a8_down_kernel<KS>;
};

constexpr size_t w8_down_smem_bytes() {
  return (size_t)PJ_STAGES * (64 * W8_A_LD + PJ_BK * PJ_LDB8);
}
static_assert(64 * W8_RED_LD * 4 <= w8_down_smem_bytes(), "the partial tile fits in the rings");

}  // namespace

// Launches both kernels on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_mlp_block_w8a8(const void* x, const void* ln, const void* wg, const void* sg,
                                     const void* wu, const void* su, const void* wd,
                                     const void* sd, void* p8, void* ps, void* out, int M, int D,
                                     int I, float eps, void* stream) {
  if (M < 1 || D < 16 || I < 16 || D % 16 || I % 16 || w8_gate_up_smem_bytes(D, I) > (size_t)PJ_MAX_DSMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpW8A8Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const bf16*>(ln);
  a.eps = eps;
  a.wg = static_cast<const signed char*>(wg);
  a.wu = static_cast<const signed char*>(wu);
  a.sg = static_cast<const bf16*>(sg);
  a.su = static_cast<const bf16*>(su);
  a.p8 = static_cast<signed char*>(p8);
  a.ps = static_cast<float*>(ps);
  a.wd = static_cast<const signed char*>(wd);
  a.sd = static_cast<const bf16*>(sd);
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.D = D;
  a.I = I;
  const dim3 grid(W8_CLUSTER, (M + W8_ROWS - 1) / W8_ROWS);
  int err;
  const size_t gsmem = w8_gate_up_smem_bytes(D, I);
  switch (w8_ntc(I)) {
    case 1: err = pj_launch<MlpW8A8GateUp<1>::value>(a, grid, 64, gsmem, W8_CLUSTER, st); break;
    case 2: err = pj_launch<MlpW8A8GateUp<2>::value>(a, grid, 128, gsmem, W8_CLUSTER, st); break;
    case 3: err = pj_launch<MlpW8A8GateUp<3>::value>(a, grid, 192, gsmem, W8_CLUSTER, st); break;
    default: err = pj_launch<MlpW8A8GateUp<4>::value>(a, grid, 256, gsmem, W8_CLUSTER, st); break;
  }
  if (err) return err;
  const int ks = dense_split(M, D, I);
  const dim3 dgrid((D + PJ_BN - 1) / PJ_BN * ks, (M + 63) / 64);
  const size_t smem = w8_down_smem_bytes();
  switch (ks) {
    case 1: return pj_launch<MlpW8A8Down<1>::value>(a, dgrid, 128, smem, 1, st);
    case 2: return pj_launch<MlpW8A8Down<2>::value>(a, dgrid, 128, smem, 2, st);
    case 4: return pj_launch<MlpW8A8Down<4>::value>(a, dgrid, 128, smem, 4, st);
    default: return pj_launch<MlpW8A8Down<8>::value>(a, dgrid, 128, smem, 8, st);
  }
}
