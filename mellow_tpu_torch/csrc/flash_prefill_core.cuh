// The causal GQA core of TPU kernel #10 (pallas_attention.flash_gqa_prefill,
// its "square" _kernel) for Hopper (sm_90a): register-resident tensor-core
// tiles, a cp.async ring of key/value tiles and two passes over the causal
// key tiles, so that the softmax uses each row's true maximum without
// keeping a row of scores anywhere.
//
// The function, with the TPU kernel's rounding points:
//   s = (q . k) in fp32, times the fp32 scale; -1e30 above the diagonal;
//   m = the row's true maximum;  e = exp(s - m);
//   o = bf16(e) @ v, accumulated in fp32, divided by the fp32 sum of the
//       unrounded e.
// Pass 1 computes Q K^T for the row maxima only; pass 2 computes it again
// (bit for bit the same: the same mma.sync instructions on the same
// operands in the same order), forms e, its sum and bf16(e), and runs the
// PV product. An online (running-max) softmax would round exp(s - m_running)
// to bf16 where the TPU kernel rounds exp(s - m), so it is not used; the
// second Q K^T costs S^2 hd operations per head.
//
// Layout of the work:
//   * a block owns 64 query rows of HB query heads of one KV group (HB, a
//     divisor of H / KV of at most 4, is a template parameter): one
//     warpgroup of 4 warps per head, 16 rows per warp, and the HB heads
//     share every K and V tile the block stages;
//   * with KS = 2 (one head a block: GPT-2's H = KV), a second warpgroup
//     takes every other key tile of the same rows, which halves the chain
//     of key tiles of the heaviest block; the two share their row maxima
//     after pass 1 and their sums after pass 2 through shared memory, and
//     each writes half of the output columns;
//   * the products are mma.sync.m16n8k16 bf16 with fp32 accumulators in the
//     FlashAttention-2 register layout: the warp keeps its Q rows as A
//     fragments, its 16 x 64 score tile in registers, and the score
//     accumulator of a key tile becomes, rounded to bf16, the A operand of
//     the PV product without a trip through shared memory; K fragments come
//     from shared memory by ldmatrix, V fragments by ldmatrix.trans;
//   * key tiles of 64 rows go through a ring in shared memory (a stage holds
//     KS K tiles and KS V tiles of 64 x 72 bf16, 9 KB each; 3 stages, 54 KB,
//     with KS = 1, 2 stages, 72 KB, with KS = 2), filled by 16-byte cp.async
//     with commit/wait groups, so the next tiles are in flight during the
//     current tile's products; key rows past S arrive as zeros;
//   * the score products of a key tile issue all eight 8-key blocks'
//     ldmatrix loads, then their mma.sync instructions back to back, so the
//     independent accumulator chains overlap (a loop with a branch per
//     block serialised them);
//   * causal work: a block reads key tiles 0..qt for its query tile qt only
//     (tiles above the diagonal are never loaded), only the diagonal tile is
//     masked element by element, and within it a warp skips the key columns
//     past its last row; blocks take the query tiles in reverse order, so
//     the heaviest launch first;
//   * the epilogue divides in registers, rounds to bf16, stages each warp's
//     16 x 64 tile through shared memory and writes it with 16-byte stores.
// Shared memory does not grow with S; the launcher caps S at FP_MAX_S.
//
// Strides: q row s of batch b starts at b * q_bstride +
// s * ldq, k and v rows at b * kv_bstride + s * ldkv (head h at column h * 64,
// group g at g * 64); bases and strides are multiples of 8 elements. The
// output is contiguous (B, S, H * 64).

#pragma once

#include "func_attrs.cuh"
#include "bf16_util.cuh"

namespace {

constexpr int FP_HD = 64;                  // head width (GPT-2 and SmolLM2)
constexpr int FP_ROWS = 64;                // query rows per head per block
constexpr int FP_KEYS = 64;                // keys per tile
constexpr int FP_LD = FP_HD + 8;           // smem row stride: 144 bytes, ldmatrix conflict-free
constexpr int FP_TILE = FP_KEYS * FP_LD;   // elements of one K or V tile
constexpr int FP_MAX_S = 8192;

__device__ __forceinline__ uint32_t fp_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zero-filled
// and nothing is read.
__device__ __forceinline__ void fp_cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fp_smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void fp_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void fp_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fp_ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fp_smem_addr(p)));
}

__device__ __forceinline__ void fp_ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fp_smem_addr(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void fp_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t fp_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t fp_ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Shared memory of a block: the ring (KS K tiles and KS V tiles a stage).
template <int KS>
__host__ __device__ constexpr int fp_stages() { return KS == 1 ? 3 : 2; }
template <int KS>
__host__ __device__ constexpr int fp_smem_bytes() { return fp_stages<KS>() * 2 * KS * FP_TILE * 2; }

template <int HB, int KS>
__global__ void __launch_bounds__(128 * HB * KS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KV,
                     long long q_bstride, int ldq, long long kv_bstride, int ldkv, float scale) {
  constexpr int STAGES = fp_stages<KS>();
  constexpr int NT = 128 * HB * KS;
  constexpr int NJ = FP_HD / 8 / KS;  // output column blocks of 8 a warp writes
  extern __shared__ __align__(128) unsigned char fp_smem[];
  __shared__ float mx[KS][4 * HB][16];  // pass 1's row maxima of each key split
  // Stage s: K tiles [0, KS), then V tiles [KS, 2 KS), each FP_TILE elements.
  bf16* ring = reinterpret_cast<bf16*>(fp_smem);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest query tiles first
  const int q0 = qt * FP_ROWS;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int chunks = rep / HB;
  const int g = blockIdx.y / chunks;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ks = warp / (4 * HB);   // the warp's key split: key tiles t with t % KS == ks
  const int hw = warp % (4 * HB);   // the warp among the 4 HB row warps
  const int wg_warp = hw % 4;       // warp within its head's warpgroup
  const int h = g * rep + (blockIdx.y % chunks) * HB + hw / 4;
  const int wrow = q0 + wg_warp * 16;  // the warp's first query row
  const int gid = lane >> 2;           // fragment row (and row + 8)
  const int tig = lane & 3;            // fragment column pair
  const bf16* kb = k + (size_t)b * kv_bstride + (size_t)g * FP_HD;
  const bf16* vb = v + (size_t)b * kv_bstride + (size_t)g * FP_HD;
  const int n_tiles = qt + 1;                // key tiles 0..qt; tile qt is the diagonal
  const int n_groups = (n_tiles + KS - 1) / KS;  // a stream step covers KS key tiles
  const int total = 2 * n_groups;            // pass 1 streams K tiles, pass 2 K and V tiles

  // Stream step u: pass 1 group u (K), then pass 2 group u - n_groups (K, V).
  auto issue = [&](int u) {
    if (u < total) {
      const int grp = u < n_groups ? u : u - n_groups;
      const int parts = u < n_groups ? 1 : 2;
      bf16* st = ring + (u % STAGES) * 2 * KS * FP_TILE;
      for (int e = tid; e < parts * KS * FP_KEYS * (FP_HD / 8); e += NT) {
        const int which = e / (KS * FP_KEYS * (FP_HD / 8));  // 0: K, 1: V
        const int kt = (e / (FP_KEYS * (FP_HD / 8))) % KS;
        const int r = (e / (FP_HD / 8)) % FP_KEYS;
        const int c = (e % (FP_HD / 8)) * 8;
        const int t = grp * KS + kt;
        const int key = t * FP_KEYS + r;
        const bool valid = t < n_tiles && key < S;
        const bf16* src = (which ? vb : kb) + (size_t)(valid ? key : 0) * ldkv + c;
        fp_cp_async16(st + (which * KS + kt) * FP_TILE + r * FP_LD + c, src, valid);
      }
    }
    fp_cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  for (int u = 0; u < STAGES - 1; ++u) issue(u);

  // The warp's 16 query rows as A fragments, one per 16 dims: {(gid, 2 tig),
  // (gid + 8, 2 tig), (gid, 2 tig + 8), (gid + 8, 2 tig + 8)}; rows past S are 0.
  uint32_t qa[FP_HD / 16][4];
  {
    const bf16* qb = q + (size_t)b * q_bstride + (size_t)h * FP_HD;
    const int r0 = wrow + gid, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < FP_HD / 16; ++kk) {
      const int c = kk * 16 + 2 * tig;
      qa[kk][0] = r0 < S ? fp_ld32(qb + (size_t)r0 * ldq + c) : 0u;
      qa[kk][1] = r1 < S ? fp_ld32(qb + (size_t)r1 * ldq + c) : 0u;
      qa[kk][2] = r0 < S ? fp_ld32(qb + (size_t)r0 * ldq + c + 8) : 0u;
      qa[kk][3] = r1 < S ? fp_ld32(qb + (size_t)r1 * ldq + c + 8) : 0u;
    }
  }

  float m[2] = {-1e30f, -1e30f};  // rows gid and gid + 8; column 0 is never masked
  float l[2] = {0.f, 0.f};
  float oacc[FP_HD / 8][4];
#pragma unroll
  for (int j = 0; j < FP_HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[j][i] = 0.f;

  for (int u = 0; u < total; ++u) {
    fp_cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(u + STAGES - 1);
    if (KS > 1 && u == n_groups) {
      // The row maxima over every key split.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int o2 = 0; o2 < KS; ++o2) m[i] = fmaxf(m[i], mx[o2][hw][gid + 8 * i]);
    }
    const int t = (u < n_groups ? u : u - n_groups) * KS + ks;
    if (t < n_tiles) {  // warp-uniform
      const bf16* kt_s = ring + (u % STAGES) * 2 * KS * FP_TILE + ks * FP_TILE;
      const bool diag = t == qt;

      // s[j]: the 16 x 8 score block of keys 8j..8j+7: (gid, 2 tig + {0, 1}),
      // (gid + 8, 2 tig + {0, 1}). All eight blocks' products are issued
      // together, so the independent mma chains overlap.
      float s[FP_KEYS / 8][4];
#pragma unroll
      for (int j = 0; j < FP_KEYS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < FP_HD / 16; kk += 2) {
        uint32_t kf[FP_KEYS / 8][4];  // K rows 8j.., dims 16kk + {0, 8, 16, 24}
#pragma unroll
        for (int j = 0; j < FP_KEYS / 8; ++j)
          fp_ldmatrix_x4(kf[j], kt_s + (8 * j + (lane & 7)) * FP_LD + 16 * kk + 8 * (lane >> 3));
#pragma unroll
        for (int j = 0; j < FP_KEYS / 8; ++j) fp_mma(s[j], qa[kk], kf[j][0], kf[j][1]);
#pragma unroll
        for (int j = 0; j < FP_KEYS / 8; ++j) fp_mma(s[j], qa[kk + 1], kf[j][2], kf[j][3]);
      }
#pragma unroll
      for (int j = 0; j < FP_KEYS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[j][i] * scale;
          if (diag) {
            const int row = wrow + gid + (i >= 2 ? 8 : 0);
            const int col = t * FP_KEYS + 8 * j + 2 * tig + (i & 1);
            if (col > row) x = -1e30f;
          }
          s[j][i] = x;
        }

      if (u < n_groups) {
        // Pass 1: the row maxima.
#pragma unroll
        for (int j = 0; j < FP_KEYS / 8; ++j) {
          m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
          m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
        }
      } else {
        // Pass 2: e = exp(s - m), its fp32 sum, bf16(e) as the A fragments of
        // PV (keys 16kk..16kk+15: blocks 2kk and 2kk + 1).
        uint32_t pa[FP_KEYS / 16][4];
#pragma unroll
        for (int j = 0; j < FP_KEYS / 8; ++j) {
          const float e0 = expf(s[j][0] - m[0]);
          const float e1 = expf(s[j][1] - m[0]);
          const float e2 = expf(s[j][2] - m[1]);
          const float e3 = expf(s[j][3] - m[1]);
          l[0] += e0;
          l[0] += e1;
          l[1] += e2;
          l[1] += e3;
          pa[j / 2][(j % 2) * 2] = fp_pack(e0, e1);
          pa[j / 2][(j % 2) * 2 + 1] = fp_pack(e2, e3);
        }
        // In the diagonal tile the warp's rows see keys up to wrow + 15 only:
        // the key steps past them carry exp = 0 and are skipped.
        const int kmax = diag ? wg_warp + 1 : FP_KEYS / 16;
        const bf16* vt_s = kt_s + KS * FP_TILE;
#pragma unroll
        for (int kk = 0; kk < FP_KEYS / 16; ++kk) {
          if (kk < kmax) {
            uint32_t vf[FP_HD / 16][4];  // V keys 16kk + {0, 8}, dims 16jj + {0, 8}, transposed
#pragma unroll
            for (int jj = 0; jj < FP_HD / 16; ++jj)
              fp_ldmatrix_x4_trans(vf[jj], vt_s + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * FP_LD +
                                               16 * jj + 8 * (lane >> 4));
#pragma unroll
            for (int jj = 0; jj < FP_HD / 16; ++jj) {
              fp_mma(oacc[2 * jj], pa[kk], vf[jj][0], vf[jj][1]);
              fp_mma(oacc[2 * jj + 1], pa[kk], vf[jj][2], vf[jj][3]);
            }
          }
        }
      }
    }
    if (u == n_groups - 1) {
      // End of pass 1: the maxima over the quad's columns, shared across the
      // key splits at the next step's barrier.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      }
      if (KS > 1 && tig == 0) {
        mx[ks][hw][gid] = m[0];
        mx[ks][hw][gid + 8] = m[1];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  fp_cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it
  // Key splits: warp ks owns the output column blocks [ks NJ, (ks + 1) NJ);
  // each hands its sums of the other blocks and its row sums to their owner.
  const int j0 = ks * NJ;
  if (KS > 1) {
    float* xo = reinterpret_cast<float*>(fp_smem);  // [owner ks][hw][16 x 64 + 16] fp32
    constexpr int XW = 16 * FP_HD + 16;
#pragma unroll
    for (int o2 = 0; o2 < KS; ++o2) {
      if (o2 == ks) continue;
      float* dst = xo + (o2 * 4 * HB + hw) * XW;
#pragma unroll
      for (int j = o2 * NJ; j < (o2 + 1) * NJ; ++j) {
        dst[gid * FP_HD + 8 * j + 2 * tig] = oacc[j][0];
        dst[gid * FP_HD + 8 * j + 2 * tig + 1] = oacc[j][1];
        dst[(gid + 8) * FP_HD + 8 * j + 2 * tig] = oacc[j][2];
        dst[(gid + 8) * FP_HD + 8 * j + 2 * tig + 1] = oacc[j][3];
      }
      if (tig == 0) {
        dst[16 * FP_HD + gid] = l[0];
        dst[16 * FP_HD + gid + 8] = l[1];
      }
    }
    __syncthreads();
    const float* src = xo + (ks * 4 * HB + hw) * XW;
    // The other split's sums of the owned blocks (j stays a constant, so
    // oacc stays in registers).
#pragma unroll
    for (int j = 0; j < FP_HD / 8; ++j)
      if (j / NJ == ks) {
        oacc[j][0] += src[gid * FP_HD + 8 * j + 2 * tig];
        oacc[j][1] += src[gid * FP_HD + 8 * j + 2 * tig + 1];
        oacc[j][2] += src[(gid + 8) * FP_HD + 8 * j + 2 * tig];
        oacc[j][3] += src[(gid + 8) * FP_HD + 8 * j + 2 * tig + 1];
      }
    l[0] += src[16 * FP_HD + gid];
    l[1] += src[16 * FP_HD + gid + 8];
    __syncthreads();  // the exchange area is read: reuse it for the output
  }
  // Divide, round to bf16, stage the warp's 16 x (8 NJ) tile, write 16-byte rows.
  bf16* os = reinterpret_cast<bf16*>(fp_smem) + warp * 16 * FP_LD;
#pragma unroll
  for (int j = 0; j < FP_HD / 8; ++j)
    if (j / NJ == ks) {
      *reinterpret_cast<uint32_t*>(os + gid * FP_LD + 8 * j + 2 * tig) =
          fp_pack(oacc[j][0] / l[0], oacc[j][1] / l[0]);
      *reinterpret_cast<uint32_t*>(os + (gid + 8) * FP_LD + 8 * j + 2 * tig) =
          fp_pack(oacc[j][2] / l[1], oacc[j][3] / l[1]);
    }
  __syncwarp();
  const int ldo = H * FP_HD;
  for (int e = lane; e < 16 * NJ; e += 32) {
    const int r = e / NJ;
    const int c = (j0 + e % NJ) * 8;
    const int row = wrow + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + ((size_t)b * S + row) * ldo + (size_t)h * FP_HD + c) =
          *reinterpret_cast<const uint4*>(os + r * FP_LD + c);
  }
}

template <int HB, int KS>
int launch_flash_prefill(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                         int H, int KV, long long q_bstride, int ldq, long long kv_bstride,
                         int ldkv, cudaStream_t stream) {
  constexpr int smem = fp_smem_bytes<KS>();
  auto kernel = flash_prefill_kernel<HB, KS>;
  static std::atomic<bool> attrs_set[MELLOW_MAX_DEVICES];
  const cudaError_t err = set_func_attrs_once(attrs_set, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + FP_ROWS - 1) / FP_ROWS, KV * (H / KV / HB), B);
  kernel<<<grid, 128 * HB * KS, smem, stream>>>(q, k, v, o, S, H, KV, q_bstride, ldq, kv_bstride,
                                                ldkv, 1.f / sqrtf((float)FP_HD));
  return (int)cudaGetLastError();
}

// The heads a block shares its K/V tiles among: the largest divisor of
// H / KV that is at most 4.
inline int flash_prefill_heads_per_block(int rep) {
  for (int hb = 4; hb > 1; --hb)
    if (rep % hb == 0) return hb;
  return 1;
}

}  // namespace
