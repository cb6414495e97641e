// Fused dense + activation + few-bit codes with the epilogue of one tile
// under the product of the next: the fourth schedule of dense_act.cu's
// function, z = x @ w + b, y = act(z), the codes of z packed into bit
// planes.
//
// Replaces tools/exp_megakernel.py: make_pipelined / pipelined_kernel, the
// grid step that runs the epilogue of row block i - 1 beside the product of
// row block i, z in a two-slot scratch.
//
// What bounds it on this card: dense_act.cu's bound, the tensor cores; the
// epilogue (a quarter of the k loop's time in f32, half in bf16) is what
// this schedule tries to hide.  In the k loop both warpgroups of the one
// block an SM holds finish their product together and run the epilogue
// together, with the tensor cores idle.
//
// Design: a persistent grid, one block per SM, each walking the 64 x BN
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... (columns fastest, so the
// blocks of one wave share rows of x and all of w in L2).  The two consumer
// warpgroups take whole tiles in turns (ping-pong): warpgroup 0 the block's
// tiles 0, 2, ..., warpgroup 1 tiles 1, 3, ....  The two slots of the TPU
// kernel's scratch are the two warpgroups' accumulator fragments.  The
// producer thread loads the stages of all tiles in order and runs ahead of
// both, also across an epilogue; a stage is freed by the one warpgroup that
// reads it.  Two named barriers order the mainloops: a warpgroup starts its
// product when the other has finished issuing its own, and then runs its
// epilogue on CUDA cores while the other's wgmma runs.  A 64-row tile
// keeps a warpgroup's accumulator at BN / 2 registers, as in the k loop, at
// the price of reading each tile of w for 64 rows of x, not 128.
//
// On an H100 SXM at 700 W, 8192 x 768 -> 3072: 0.52 ms in f32 (the k loop:
// 0.51) and 0.245 ms in bf16 (0.262): one warpgroup's product on 64 rows
// takes nearly as long as two warpgroups' on 128, so little of the epilogue
// ends up hidden.  Registers 128-132 (f32), 93-116 (bf16), no spills.
#include "dense_act_epilogue.cuh"

namespace fewbit {
namespace {

constexpr int PP_BM = 64;  // rows of a tile: one warpgroup's

// Dynamic shared memory of a block: the ring (64 rows of x, BN of w, for
// f32 twice), the table, the barriers and the slack that aligns the ring to
// 1024 bytes.  _dense_act_pipelined_smem in fewbit_tpu_torch/ops/kernels.py
// computes the same; fewbit_dense_act_pipelined_smem exports this one.
constexpr int pp_smem(int parts, int bn) {
  return FG_STAGES * (PP_BM + parts * bn) * hopper::ROW_BYTES + FG_TABLE * 4 +
         2 * FG_STAGES * 8 + 1024;
}

template <typename T, int BN>
struct PpSmem {
  static constexpr int BK = Operand<T>::BK, PARTS = Operand<T>::PARTS;
  static constexpr int A_BYTES = PP_BM * hopper::ROW_BYTES;
  static constexpr int B_BYTES = BN * hopper::ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + PARTS * B_BYTES;

  uint8_t* ring_a;
  uint8_t* ring_b;
  float* table;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit PpSmem(uint8_t* raw) {
    uint8_t* base =
        raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
    ring_a = base;
    // 1024-byte aligned: FG_STAGES x 8 KB of A come first.
    ring_b = base + FG_STAGES * A_BYTES;
    table = reinterpret_cast<float*>(base + FG_STAGES * STAGE_BYTES);
    full = reinterpret_cast<uint64_t*>(table + FG_TABLE);
    empty = full + FG_STAGES;
  }
};

template <typename TI, typename TO, int BN, bool ANY>
__global__ void __launch_bounds__(FG_THREADS, 1)
    dense_act_pipelined_kernel(const __grid_constant__ CUtensorMap map_a,
                               const __grid_constant__ CUtensorMap map_b,
                               const __grid_constant__ CUtensorMap map_b_lo,
                               DaParams<TI, TO> p, ActArgs act) {
  using namespace hopper;
  using S = PpSmem<TI, BN>;
  extern __shared__ uint8_t smem_raw[];
  const S s(smem_raw);
  da_fill_table(s.table, p.borders, p.n_borders);
  if (threadIdx.x == 0) {
    for (int i = 0; i < FG_STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 128);  // the one warpgroup that reads a stage
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int k_tiles = p.kdim / S::BK;
  const int col_tiles = p.m / BN;
  const int tiles = ((p.n + PP_BM - 1) / PP_BM) * col_tiles;
  // Tile j of this block is tile blockIdx.x + j gridDim.x of the grid.
  const int my_tiles =
      (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) -
       1) / static_cast<int>(gridDim.x);
  if (threadIdx.x >= FG_CONSUMERS) {  // the producer warp; one thread loads
    if (threadIdx.x == FG_CONSUMERS) {
      int st = 0;
      uint32_t ph = 0;
      for (int j = 0; j < my_tiles; ++j) {
        const int id = blockIdx.x + j * gridDim.x;
        const int row0 = (id / col_tiles) * PP_BM;
        const int col0 = (id % col_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&s.empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&s.full[st], S::STAGE_BYTES);
          uint8_t* b = s.ring_b + st * S::PARTS * S::B_BYTES;
          tma_load_2d(s.ring_a + st * S::A_BYTES, &map_a, &s.full[st],
                      kt * S::BK, row0);
          tma_load_2d(b, &map_b, &s.full[st], kt * S::BK, col0);
          if (S::PARTS == 2)
            tma_load_2d(b + S::B_BYTES, &map_b_lo, &s.full[st], kt * S::BK,
                        col0);
          if (++st == FG_STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }
  FgThread th;
  const int wg = th.wg;  // which tiles it takes; a stage's A has 64 rows
  th.row -= 64 * wg;
  th.wg = 0;
  // Barrier 2 + w: warpgroup w may start its product.  Warpgroup 0 starts.
  if (wg == 1) bar_arrive(2, FG_CONSUMERS);
  for (int j = wg; j < my_tiles; j += 2) {
    const int id = blockIdx.x + j * gridDim.x;
    const int row0 = (id / col_tiles) * PP_BM, col0 = (id % col_tiles) * BN;
    // Tile j's stages follow those of the j tiles before it in the ring.
    const int pos = j * k_tiles;
    int st = pos % FG_STAGES;
    uint32_t ph = (pos / FG_STAGES) & 1;
    float acc[BN / 2];
    bar_sync(2 + wg, FG_CONSUMERS);
    fg_consume_pass<TI, BN>(acc, s, th, k_tiles, st, ph);
    bar_arrive(2 + (wg ^ 1), FG_CONSUMERS);
    da_epilogue<TI, TO, BN, true, ANY>(acc, p, act, s.table, row0, col0,
                                       th.warp, th.g, th.t,
                                       DaStoreGlobal<TO>{p.y, p.n, p.m});
  }
}

template <typename TI, typename TO, int BN, bool ANY>
int launch_pipelined(const CUtensorMap& ma, const CUtensorMap& mb,
                     const CUtensorMap& mb_lo, const DaParams<TI, TO>& p,
                     const ActArgs& act, cudaStream_t st) {
  auto kernel = dense_act_pipelined_kernel<TI, TO, BN, ANY>;
  static unsigned allowed = 0;
  const int err =
      fg_allow_smem(reinterpret_cast<const void*>(kernel), allowed);
  if (err != 0) return err;
  const long long tiles =
      (long long)((p.n + PP_BM - 1) / PP_BM) * (p.m / BN);
  const int sms = da_sm_count();
  kernel<<<static_cast<unsigned>(tiles < sms ? tiles : sms), FG_THREADS,
           pp_smem(Operand<TI>::PARTS, BN), st>>>(ma, mb, mb_lo, p, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit

// The pipelined (ping-pong) schedule.  Arguments, scratch and return value
// as fewbit_dense_act_kloop's (dense_act.cu), without its `epilogue`;
// ceil(n / 64) * (m / bn) * (kdim / 32) must fit an int.
extern "C" int fewbit_dense_act_pipelined(const void* x, const void* w,
                                          int w_trans, const void* bias,
                                          const void* borders, int n_borders,
                                          const void* act_args, void* y,
                                          void* packed, void* w_prep, int n,
                                          int kdim, int m, int bits, int bn,
                                          int in_bf16, int out_bf16,
                                          void* stream) {
  using namespace fewbit;
  const ActArgs act = *static_cast<const ActArgs*>(act_args);
  if (!da_args_ok(n_borders, bits, act, 1) || (bn != 64 && bn != 96) ||
      n <= 0 || m <= 0 || kdim <= 0 ||
      (long long)((n + PP_BM - 1) / PP_BM) * (m / bn) * (kdim / 32) >
          0x7fffffffLL)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return da_dispatch_types(in_bf16, out_bf16, [&](auto ti, auto to) {
    using TI = decltype(ti);
    using TO = decltype(to);
    CUtensorMap ma, mb, mb_lo;
    const int rc = fg_operands_any_rows<TI>(x, PP_BM, w, w_trans, w_prep, n,
                                            kdim, m, bn, &ma, &mb, &mb_lo, st);
    if (rc != 0) return rc;
    const DaParams<TI, TO> p = da_params<TI, TO>(bias, borders, n_borders, y,
                                                 packed, n, kdim, m, bits);
    if (da_any(act))
      return bn == 96
                 ? launch_pipelined<TI, TO, 96, true>(ma, mb, mb_lo, p, act, st)
                 : launch_pipelined<TI, TO, 64, true>(ma, mb, mb_lo, p, act,
                                                      st);
    return bn == 96
               ? launch_pipelined<TI, TO, 96, false>(ma, mb, mb_lo, p, act, st)
               : launch_pipelined<TI, TO, 64, false>(ma, mb, mb_lo, p, act,
                                                     st);
  });
}

// The dynamic shared memory of a block of the pipelined schedule at tile
// width bn, or -1 for a width not built.  Launches nothing.
extern "C" int fewbit_dense_act_pipelined_smem(int bn, int is_bf16) {
  if (bn != 64 && bn != 96) return -1;
  return fewbit::pp_smem(is_bf16 ? 1 : 2, bn);
}
