// Fused dense + activation + few-bit codes with the weight resident in
// shared memory: two more schedules of dense_act.cu's function, z = x @ w +
// b, y = act(z), the codes of z packed into bit planes.
//
// Replaces tools/exp_megakernel.py: make_direct / direct_kernel (no k split
// and no accumulator scratch: z stays in registers between the product and
// the epilogue; with wres the weight stays resident and the grid runs over
// rows only) and make_emit (the same with an inner software pipeline that
// streams row blocks in and y out through double buffers, the weight
// fetched once).
//
// What bounds it on this card: dense_act.cu's bound, the tensor cores.
// What these schedules change is what the ring carries: the k loop reads a
// 128 x BN tile's slice of w once per tile, 64 times per column panel at
// N = 8192, from L2; here a block reads its panel once.
//
// The direct schedule (TMA_STORE = false): a block owns one K x BN column
// panel of w, loaded once by TMA into shared memory as K / BK swizzled
// tiles (bf16 at K = 768, BN = 96: 147 KB), and walks the 128-row tiles of
// that panel that are its share (grid.x blocks per panel, as many as the
// SMs allow); only x streams through the ring of 4 stages, and wgmma reads
// B from the panel.  The accumulator fragment goes straight into the
// epilogue, which stores y from registers.  da_resident_smem says where the
// panel fits beside the ring: for f32 as 3xTF32 (two halves of the panel)
// it does not at K = 768, and the host asks before it launches.
//
// The emit schedule (TMA_STORE = true): the same, with the output pipelined
// too.  Each warpgroup stages its 64 x BN half of y in one of two
// shared-memory buffers and one thread writes it out by a TMA bulk store, so
// tile i's store runs under tile i + 1's product; the buffer is written
// again only when the store two tiles back has read it
// (cp.async.bulk.wait_group.read 1).  The store drops the rows past N.  The
// two buffers leave room for a 64-wide panel only at K = 768.
//
// On an H100 SXM at 700 W, 8192 x 768 -> 3072 in bf16: direct 0.25 ms at the
// 96-wide panel (the k loop: 0.262) and 0.36 ms at 64, where only 96 blocks
// (48 panels x 2) fill the 132 SMs; emit 0.36-0.37 ms.  Registers 128-139
// (f32), 93-105 (bf16), no spills.
#include "dense_act_epilogue.cuh"

namespace fewbit {
namespace {

// Dynamic shared memory of a block: the ring of x tiles, the resident
// panel, the staged output (emit only), the table, the barriers (full and
// empty per stage, and the panel's) and the slack that aligns the ring to
// 1024 bytes.  _dense_act_resident_smem in fewbit_tpu_torch/ops/kernels.py
// computes the same; fewbit_dense_act_resident_smem exports this one.
constexpr int da_resident_smem(int parts, int kdim, int bn, int out_bytes,
                               bool tma_store) {
  return FG_STAGES * FG_BM * hopper::ROW_BYTES +
         parts * bn * kdim * (parts == 2 ? 4 : 2) +
         (tma_store ? 2 * FG_BM * bn * out_bytes : 0) + FG_TABLE * 4 +
         (2 * FG_STAGES + 1) * 8 + 1024;
}

// da_resident_smem of the flags' element types, or -1 where the kernels
// refuse the depth, the width or the types, or the block would exceed
// FG_SMEM_LIMIT.
inline int da_resident_smem_or_refuse(int kdim, int bn, int in_bf16,
                                      int out_bf16, bool tma_store) {
  if ((bn != 64 && bn != 96) || kdim <= 0 || kdim % 128 || kdim > 16384 ||
      (!in_bf16 && out_bf16))
    return -1;
  const int smem = da_resident_smem(in_bf16 ? 1 : 2, kdim, bn,
                                    out_bf16 ? 2 : 4, tma_store);
  return smem > FG_SMEM_LIMIT ? -1 : smem;
}

template <typename TI, typename TO, int BN>
struct ResidentSmem {
  static constexpr int BK = Operand<TI>::BK, PARTS = Operand<TI>::PARTS;
  static constexpr int A_BYTES = FG_BM * hopper::ROW_BYTES;
  static constexpr int B_BYTES = BN * hopper::ROW_BYTES;

  uint8_t* ring_a;  // FG_STAGES tiles of x
  uint8_t* ring_b;  // unused: B is the panel
  uint8_t* panel;   // k_tiles x PARTS tiles of w
  TO* stage;        // [2 buffers][2 warpgroups][64][BN] of y (emit only)
  float* table;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* panel_full;

  __device__ __forceinline__ ResidentSmem(uint8_t* raw, int k_tiles,
                                          bool tma_store) {
    uint8_t* base =
        raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
    ring_a = base;
    ring_b = nullptr;
    panel = base + FG_STAGES * A_BYTES;
    uint8_t* after = panel + k_tiles * PARTS * B_BYTES;
    stage = reinterpret_cast<TO*>(after);
    if (tma_store) after += 2 * FG_BM * BN * sizeof(TO);
    table = reinterpret_cast<float*>(after);
    full = reinterpret_cast<uint64_t*>(table + FG_TABLE);
    empty = full + FG_STAGES;
    panel_full = empty + FG_STAGES;
  }
};

template <typename TI, typename TO, int BN, bool TMA_STORE, bool ANY>
__global__ void __launch_bounds__(FG_THREADS, 1)
    dense_act_resident_kernel(const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_b,
                              const __grid_constant__ CUtensorMap map_b_lo,
                              const __grid_constant__ CUtensorMap map_y,
                              DaParams<TI, TO> p, ActArgs act) {
  using namespace hopper;
  using S = ResidentSmem<TI, TO, BN>;
  extern __shared__ uint8_t smem_raw[];
  const int k_tiles = p.kdim / S::BK;
  const S s(smem_raw, k_tiles, TMA_STORE);
  da_fill_table(s.table, p.borders, p.n_borders);
  if (threadIdx.x == 0) {
    for (int i = 0; i < FG_STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], FG_CONSUMERS);
    }
    mbar_init(s.panel_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int col0 = blockIdx.y * BN;
  const int row_tiles = (p.n + FG_BM - 1) / FG_BM;
  if (threadIdx.x >= FG_CONSUMERS) {  // the producer warp; one thread loads
    if (threadIdx.x == FG_CONSUMERS) {
      // The panel, once: every k tile of this block's columns.
      mbar_arrive_expect_tx(s.panel_full, k_tiles * S::PARTS * S::B_BYTES);
      for (int kt = 0; kt < k_tiles; ++kt) {
        uint8_t* b = s.panel + kt * S::PARTS * S::B_BYTES;
        tma_load_2d(b, &map_b, s.panel_full, kt * S::BK, col0);
        if (S::PARTS == 2)
          tma_load_2d(b + S::B_BYTES, &map_b_lo, s.panel_full, kt * S::BK,
                      col0);
      }
      // x, tile after tile, in the order the consumers take it.
      int st = 0;
      uint32_t ph = 0;
      for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x)
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&s.empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&s.full[st], S::A_BYTES);
          tma_load_2d(s.ring_a + st * S::A_BYTES, &map_a, &s.full[st],
                      kt * S::BK, rt * FG_BM);
          if (++st == FG_STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }
  const FgThread th;
  const bool wg_leader = threadIdx.x % 128 == 0;
  const int wg_bar = 4 + th.wg;  // named barrier of this warpgroup
  mbar_wait(s.panel_full, 0);
  int st = 0, buf = 0;
  uint32_t ph = 0;
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int wg_row0 = rt * FG_BM + 64 * th.wg;
    float acc[BN / 2];
    fg_consume_pass<TI, BN>(acc, s, th, k_tiles, st, ph, s.panel);
    if constexpr (TMA_STORE) {
      TO* stage = s.stage + (buf * 2 + th.wg) * 64 * BN;
      // The store of two tiles back has read this buffer.
      if (wg_leader) bulk_wait_read<1>();
      bar_sync(wg_bar, 128);
      const DaStoreStage<TO, BN> to_stage{stage, wg_row0, col0};
      da_epilogue<TI, TO, BN, true, ANY>(acc, p, act, s.table, wg_row0, col0,
                                         th.warp, th.g, th.t, to_stage);
      fence_proxy_async();
      bar_sync(wg_bar, 128);
      if (wg_leader) {
        if (wg_row0 < p.n) tma_store_2d(&map_y, stage, col0, wg_row0);
        bulk_commit();
      }
      buf ^= 1;
    } else {
      da_epilogue<TI, TO, BN, true, ANY>(acc, p, act, s.table, wg_row0, col0,
                                         th.warp, th.g, th.t,
                                         DaStoreGlobal<TO>{p.y, p.n, p.m});
    }
  }
  // Shared memory must outlive the stores that read it.
  if (TMA_STORE && wg_leader) bulk_wait<0>();
}

template <typename TI, typename TO, int BN, bool TMA_STORE, bool ANY>
int launch_resident(const CUtensorMap& ma, const CUtensorMap& mb,
                    const CUtensorMap& mb_lo, const CUtensorMap& my,
                    const DaParams<TI, TO>& p, const ActArgs& act,
                    cudaStream_t st) {
  auto kernel = dense_act_resident_kernel<TI, TO, BN, TMA_STORE, ANY>;
  static unsigned allowed = 0;
  const int err =
      fg_allow_smem(reinterpret_cast<const void*>(kernel), allowed);
  if (err != 0) return err;
  // As many blocks per column panel as the SMs allow, at most one per row
  // tile.
  const int panels = p.m / BN, row_tiles = (p.n + FG_BM - 1) / FG_BM;
  int per_panel = da_sm_count() / panels;
  if (per_panel > row_tiles) per_panel = row_tiles;
  if (per_panel < 1) per_panel = 1;
  kernel<<<dim3(per_panel, panels), FG_THREADS,
           da_resident_smem(Operand<TI>::PARTS, p.kdim, BN, sizeof(TO),
                            TMA_STORE),
           st>>>(ma, mb, mb_lo, my, p, act);
  return static_cast<int>(cudaGetLastError());
}

template <bool TMA_STORE>
int dense_act_resident(const void* x, const void* w, int w_trans,
                       const void* bias, const void* borders, int n_borders,
                       const ActArgs& act, void* y, void* packed, void* w_prep,
                       int n, int kdim, int m, int bits, int bn, int in_bf16,
                       int out_bf16, cudaStream_t st) {
  if (!da_args_ok(n_borders, bits, act, 1) ||
      da_resident_smem_or_refuse(kdim, bn, in_bf16, out_bf16, TMA_STORE) < 0)
    return -1;
  return da_dispatch_types(in_bf16, out_bf16, [&](auto ti, auto to) {
    using TI = decltype(ti);
    using TO = decltype(to);
    CUtensorMap ma, mb, mb_lo, my;
    const int rc = fg_operands_any_rows<TI>(x, FG_BM, w, w_trans, w_prep, n,
                                            kdim, m, bn, &ma, &mb, &mb_lo, st);
    if (rc != 0) return rc;
    if (!hopper::make_plain_map(&my, y, sizeof(TO) == 2, n, m, 64, bn))
      return -2;
    const DaParams<TI, TO> p = da_params<TI, TO>(bias, borders, n_borders, y,
                                                 packed, n, kdim, m, bits);
    if (da_any(act))
      return bn == 96 ? launch_resident<TI, TO, 96, TMA_STORE, true>(
                            ma, mb, mb_lo, my, p, act, st)
                      : launch_resident<TI, TO, 64, TMA_STORE, true>(
                            ma, mb, mb_lo, my, p, act, st);
    return bn == 96 ? launch_resident<TI, TO, 96, TMA_STORE, false>(
                          ma, mb, mb_lo, my, p, act, st)
                    : launch_resident<TI, TO, 64, TMA_STORE, false>(
                          ma, mb, mb_lo, my, p, act, st);
  });
}

}  // namespace
}  // namespace fewbit

// The direct schedule.  Arguments, scratch and return value as
// fewbit_dense_act_kloop's (dense_act.cu), without its `epilogue`; refuses
// (-1) where the panel does not fit (fewbit_dense_act_resident_smem).
extern "C" int fewbit_dense_act_direct(const void* x, const void* w,
                                       int w_trans, const void* bias,
                                       const void* borders, int n_borders,
                                       const void* act_args, void* y,
                                       void* packed, void* w_prep, int n,
                                       int kdim, int m, int bits, int bn,
                                       int in_bf16, int out_bf16,
                                       void* stream) {
  return fewbit::dense_act_resident<false>(
      x, w, w_trans, bias, borders, n_borders,
      *static_cast<const fewbit::ActArgs*>(act_args), y, packed, w_prep, n,
      kdim, m, bits, bn, in_bf16, out_bf16,
      static_cast<cudaStream_t>(stream));
}

// The emit schedule: the direct one with y written by TMA stores; y must be
// 16-byte aligned.
extern "C" int fewbit_dense_act_emit(const void* x, const void* w, int w_trans,
                                     const void* bias, const void* borders,
                                     int n_borders, const void* act_args,
                                     void* y, void* packed, void* w_prep, int n,
                                     int kdim, int m, int bits, int bn,
                                     int in_bf16, int out_bf16, void* stream) {
  return fewbit::dense_act_resident<true>(
      x, w, w_trans, bias, borders, n_borders,
      *static_cast<const fewbit::ActArgs*>(act_args), y, packed, w_prep, n,
      kdim, m, bits, bn, in_bf16, out_bf16,
      static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a block of the direct (tma_store = 0) or the
// emit (1) schedule at depth kdim and tile width bn, or -1 where the kernel
// refuses them (a width not built, or over the block's limit).  Launches
// nothing.
extern "C" int fewbit_dense_act_resident_smem(int kdim, int bn, int in_bf16,
                                              int out_bf16, int tma_store) {
  return fewbit::da_resident_smem_or_refuse(kdim, bn, in_bf16, out_bf16,
                                            tma_store != 0);
}
