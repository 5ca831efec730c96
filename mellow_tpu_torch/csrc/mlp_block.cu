// The prefill MLP half of a Llama layer for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel mellow_tpu/ops/pallas_mlp_block.py
// (fused_mlp_block): RMSNorm; gate and up projections; silu(gate) in fp32
// rounded to bf16; up rounded to bf16; their product in bf16; the down
// projection; the residual.
//
// Contract: x (M, D) bf16 with M = B*S rows; ln (D); w_gate and w_up
// (D, I); w_down (I, D); scratch act (M, I); out (M, D). D and I are
// multiples of 8; the gate/up launch's shared memory
// (dense_panel_smem_bytes(D, 2)) is at most PJ_MAX_DSMEM.
//
// What bounds it: at the v0 prefill (M=389, D=576, I=1536) the block is
// 1.03 GFLOP against 5.3 MB of weights (bf16), so ~1 us of tensor-core
// work at the card's peak and ~1.6 us of HBM reads: on paper bytes and
// operations are close, and the latency of two dependent launches, each a
// chain of K steps, is what a call pays at B=1.
//
// What the design does about it: two launches of proj_mma_core.cuh's
// dense products (mma.sync m16n8k16 in registers, the weights through the
// cp.async ring, ldmatrix / ldmatrix.trans):
//   1. act = bf16(bf16(silu(h @ w_gate)) * bf16(h @ w_up)), h = rms_norm(x):
//      a block's 64 rows are normalised once into a whole-row panel (h is
//      rounded where the TPU kernel rounds it); each warp keeps two 16 x 64
//      accumulator sets, gate and up at the same columns, fed by the same A
//      fragments; silu, the products and the rounding happen in registers
//      and act leaves from them;
//   2. out = bf16(x + bf16(act @ w_down)), K = I = 1536: the act rows stream
//      through a ring beside the weight's (a whole-row panel would take
//      98 KB at 32 rows), and the K tiles split over a cluster of blocks
//      whose partial tiles are summed through distributed shared memory
//      (dense_split picks the split from the grid and K; its comment has
//      the readings that chose it against the unsplit stream).
// The (M, I) activation goes through device memory (1.2 MB at B=1,
// L2-resident).

#include "proj_mma_core.cuh"

namespace {

__global__ void __launch_bounds__(128) mlp_gate_up_kernel(DenseArgs p) {
  pj_dense_panel_body<PJN_RMS, PJE_SILU_MUL>(p);
}

template <int KS>
__global__ void __launch_bounds__(128) mlp_down_kernel(DenseArgs p) {
  pj_dense_stream_body<KS>(p);
}

template <int KS>
struct MlpDown {
  static constexpr auto value = &mlp_down_kernel<KS>;
};

}  // namespace

// Launches both products on `stream`; returns the first cudaError_t, 0 on
// success. Does not synchronise.
extern "C" int mellow_mlp_block(const void* x, const void* ln, const void* w_gate,
                                const void* w_up, const void* w_down, void* act, void* out, int M,
                                int D, int I, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || D < 8 || I < 8 || D % 8 || I % 8 || dense_panel_smem_bytes(D, 2) > (size_t)PJ_MAX_DSMEM)
    return (int)cudaErrorInvalidValue;
  DenseArgs g = {};
  g.a = static_cast<const bf16*>(x);
  g.gamma = static_cast<const bf16*>(ln);
  g.eps = eps;
  g.w = static_cast<const bf16*>(w_gate);
  g.w2 = static_cast<const bf16*>(w_up);
  g.out = static_cast<bf16*>(act);
  g.M = M;
  g.N = I;
  g.K = D;
  int err = launch_dense_panel<&mlp_gate_up_kernel>(g, 2, st);
  if (err) return err;
  DenseArgs d = {};
  d.a = static_cast<const bf16*>(act);
  d.w = static_cast<const bf16*>(w_down);
  d.resid = static_cast<const bf16*>(x);
  d.out = static_cast<bf16*>(out);
  d.M = M;
  d.N = D;
  d.K = I;
  return launch_dense_stream<MlpDown>(d, st);
}
