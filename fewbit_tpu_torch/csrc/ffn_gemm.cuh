// The mainloop that the few-bit FFN's forward (dense_act_sketch.cu) and
// backward (matmul_lut_backward.cu) share: acc = A @ B for one 128 x BN tile
// per pass, on the tensor cores, fed by TMA.  Each kernel adds its own
// epilogue on the accumulator fragment.  The schedules of the fused dense +
// activation kernel (dense_act.cu, dense_act_direct.cu,
// dense_act_pipelined.cu) take its consumer pass and its host side, with
// ring layouts of their own where theirs differ.
//
// - A block owns 128 buckets x BN columns and loops over the N / k_eff
//   passes itself: rows c k_eff + bucket0 + [0, 128) of every pass c fall in
//   the same 128 buckets, so whatever an epilogue sums over the passes
//   (the sketch tile, db) has one owning thread and a fixed order: no
//   atomics, bitwise repeatable.
// - One producer thread keeps TMA loads of A (128 rows x 128 bytes of K) and
//   B (BN rows, for f32 its TF32 hi and lo halves) in a ring of 4 stages
//   with a full and an empty mbarrier each.  It runs ahead of the consumers
//   by the ring's depth, also across a pass's epilogue.
// - Two consumer warpgroups, 64 rows each, run wgmma with the f32
//   accumulator in registers: bf16 with both operands from shared memory,
//   f32 as 3xTF32 (hi hi + hi lo + lo hi) with A split in registers and B's
//   halves written K-major by prep_weight_kernel.  One wgmma group stays in
//   flight while the next is started.  The compiler takes a wgmma's register
//   operands as read when it starts, so each half of a k tile has A-fragment
//   registers of its own, kept alive past the wait that retires them.
// - The sketch accumulators (BN / 2 per thread) live in shared memory, one
//   column of 256 words per fragment element (conflict free): the forward
//   takes 144 registers in f32 without them, and 48 more would pass the 168
//   a 288-thread block may have.  48 KB at BN = 96, beside a 160 KB f32
//   ring.  The last pass adds in registers and stores the sketch itself.
// - BN is 96 where it divides M (M = 3072: 32 column tiles x 16 bucket tiles
//   = 512 blocks, 3.9 waves on 132 SMs; wider tiles would need more
//   accumulator registers than the block has), else 64.  The host chooses
//   it from the shapes (ffn_gemm_route in fewbit_tpu_torch/ops/kernels.py).
#pragma once

#include "hopper_gemm.cuh"

namespace fewbit {

constexpr int FG_BM = 128;         // rows (buckets) of a block tile
constexpr int FG_STAGES = 4;       // depth of the TMA ring
constexpr int FG_CONSUMERS = 256;  // two consumer warpgroups
constexpr int FG_THREADS = FG_CONSUMERS + 32;  // and one producer warp
constexpr int FG_TABLE = 64;       // floats of the borders or levels table
constexpr int FG_SMEM_LIMIT = 232448;  // dynamic shared memory of a block

// Dynamic shared memory of a block: the ring, the sketch accumulators, one
// db row per consumer warp (the backward's), the table, the barriers and
// the slack that aligns the ring to 1024 bytes.  _ffn_smem in
// fewbit_tpu_torch/ops/kernels.py computes the same; fewbit_ffn_gemm_smem
// exports this one so a test can compare them.
constexpr int fg_smem(int parts, int bn) {
  return FG_STAGES * (FG_BM + parts * bn) * hopper::ROW_BYTES +
         (bn / 2) * FG_CONSUMERS * 4 + (FG_CONSUMERS / 32) * bn * 4 +
         FG_TABLE * 4 + 2 * FG_STAGES * 8 + 1024;
}

// fg_smem of the element type at tile width bn, or -1 where the width is
// not built or the block would exceed FG_SMEM_LIMIT.
template <typename T>
int fg_smem_or_refuse(int bn) {
  if (bn != 64 && bn != 96) return -1;
  const int smem = fg_smem(Operand<T>::PARTS, bn);
  return smem > FG_SMEM_LIMIT ? -1 : smem;
}

// The block's shared memory, carved from the dynamic allocation.
template <typename T, int BN>
struct FgSmem {
  static constexpr int BK = Operand<T>::BK, PARTS = Operand<T>::PARTS;
  static constexpr int A_BYTES = FG_BM * hopper::ROW_BYTES;
  static constexpr int B_BYTES = BN * hopper::ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + PARTS * B_BYTES;

  uint8_t* ring_a;  // FG_STAGES tiles of A
  uint8_t* ring_b;  // FG_STAGES x PARTS tiles of B
  float* ska;       // [BN / 2][FG_CONSUMERS] sketch accumulators
  float* red;       // [FG_CONSUMERS / 32][BN] db rows
  float* table;     // [FG_TABLE] borders or levels, 16-byte aligned
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit FgSmem(uint8_t* raw) {
    uint8_t* base =
        raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
    ring_a = base;
    ring_b = base + FG_STAGES * A_BYTES;
    ska = reinterpret_cast<float*>(base + FG_STAGES * STAGE_BYTES);
    red = ska + (BN / 2) * FG_CONSUMERS;
    table = red + (FG_CONSUMERS / 32) * BN;
    full = reinterpret_cast<uint64_t*>(table + FG_TABLE);
    empty = full + FG_STAGES;
  }
};

// Fills the table (`pad` past table_len), initialises the ring's barriers
// and synchronises the block.  Every thread calls it.
template <typename T, int BN>
__device__ __forceinline__ void fg_init(const FgSmem<T, BN>& s,
                                        const float* __restrict__ table,
                                        int table_len, float pad) {
  const int tid = threadIdx.x;
  if (tid < FG_TABLE) s.table[tid] = tid < table_len ? table[tid] : pad;
  if (tid == 0) {
    for (int i = 0; i < FG_STAGES; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], FG_CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// The producer thread: the tiles of every pass and k tile, in the order the
// consumers take them.  Pass c reads A at rows c pass_stride + row0.
template <typename T, int BN>
__device__ __forceinline__ void fg_produce(
    const FgSmem<T, BN>& s, const CUtensorMap* map_a,
    const CUtensorMap* map_b, const CUtensorMap* map_b_lo, int passes,
    int pass_stride, int row0, int col0, int k_tiles) {
  using S = FgSmem<T, BN>;
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < passes; ++c) {
    const int r0 = c * pass_stride + row0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      hopper::mbar_wait(&s.empty[st], ph ^ 1);
      hopper::mbar_arrive_expect_tx(&s.full[st], S::STAGE_BYTES);
      uint8_t* b = s.ring_b + st * S::PARTS * S::B_BYTES;
      hopper::tma_load_2d(s.ring_a + st * S::A_BYTES, map_a, &s.full[st],
                          kt * S::BK, r0);
      hopper::tma_load_2d(b, map_b, &s.full[st], kt * S::BK, col0);
      if (S::PARTS == 2)
        hopper::tma_load_2d(b + S::B_BYTES, map_b_lo, &s.full[st],
                            kt * S::BK, col0);
      if (++st == FG_STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  }
}

// A consumer thread's coordinates: warpgroup wg owns rows 64 wg .. 64 wg + 63
// of the tile; the thread's accumulator fragment d[4 i + 2 h + e] is row
// row + 8 h, column 8 i + 2 t + e.
struct FgThread {
  int wg, warp, g, t, row;
  __device__ __forceinline__ FgThread() {
    const int tid = threadIdx.x, lane = tid % 32;
    wg = tid / 128;
    warp = (tid % 128) / 32;
    g = lane / 4;
    t = lane % 4;
    row = 64 * wg + 16 * warp + g;
  }
};

// The default of fg_consume_pass's on_tile: nothing.
struct FgNoTile {
  __device__ __forceinline__ void operator()(const uint8_t*, int) const {}
};

// One pass of a consumer thread: acc = the thread's fragment of A @ B over
// all k tiles, taken from the ring at (st, ph), which it advances.  Every
// stage is handed back to the producer by the end.
//
// The ring is any layout with FgSmem's members and constants (ring_a,
// ring_b, full, empty; PARTS, A_BYTES, B_BYTES).  With `panel`, B is not in
// the ring: k tile kt of it (its PARTS tiles of B_BYTES) stays at
// panel + kt PARTS B_BYTES, loaded once by the caller, and a stage holds A
// alone.  th.wg selects the warpgroup's 64 rows of the stage's A tile (0
// where the tile has only 64).  on_tile(tile_a, kt) runs once a k tile,
// after its first wgmma group is issued and before its stage goes back to
// the producer, so it may read the stage's A tile (kernel 2''s x sketch);
// it must leave the warp converged.
template <typename T, int BN, typename Smem, typename OnTile = FgNoTile>
__device__ __forceinline__ void fg_consume_pass(
    float (&acc)[BN / 2], const Smem& s, const FgThread& th, int k_tiles,
    int& st, uint32_t& ph, const uint8_t* panel = nullptr,
    OnTile on_tile = {}) {
  using namespace hopper;
  using S = Smem;
  // f32: A's TF32 fragments of the two halves of a k tile (k 0..15 and
  // 16..31), each half in registers of its own, so one half's wgmma can run
  // while the other's fragments are loaded.
  uint32_t hi0[2][4] = {}, lo0[2][4] = {}, hi1[2][4] = {}, lo1[2][4] = {};
  auto load_split = [&](const uint8_t* tile_a, int ks0, uint32_t (&hi)[2][4],
                        uint32_t (&lo)[2][4]) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = th.row + 8 * (e & 1);
        const int col = 8 * (ks0 + q) + th.t + 4 * (e >> 1);
        split_tf32(*reinterpret_cast<const float*>(
                       tile_a + swizzled_offset(row, col, 4)),
                   hi[q][e], lo[q][e]);
      }
  };
  // acc += A_hi B_hi + A_hi B_lo + A_lo B_hi over k steps ks0, ks0 + 1.
  auto mma_3xtf32 = [&](const uint32_t (&hi)[2][4],
                        const uint32_t (&lo)[2][4], uint32_t b_addr,
                        int ks0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint64_t bh = desc_sw128(b_addr + 32 * (ks0 + q));
      const uint64_t bl = desc_sw128(b_addr + S::B_BYTES + 32 * (ks0 + q));
      Wgmma<BN>::tf32_rs(acc, hi[q], bh);
      Wgmma<BN>::tf32_rs(acc, hi[q], bl);
      Wgmma<BN>::tf32_rs(acc, lo[q], bh);
    }
  };
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    mbar_wait(&s.full[st], ph);
    __syncwarp();  // wgmma is .aligned: the warp converges first
    const uint8_t* tile_a = s.ring_a + st * S::A_BYTES;
    const uint32_t a_addr = smem_u32(tile_a) + 64 * th.wg * ROW_BYTES;
    const uint32_t b_addr =
        smem_u32(panel != nullptr ? panel + kt * S::PARTS * S::B_BYTES
                                  : s.ring_b + st * S::PARTS * S::B_BYTES);
    if constexpr (S::PARTS == 2) load_split(tile_a, 0, hi0, lo0);
    fence_operands(acc);
    wgmma_fence();  // after the register writes the wgmma reads
    if constexpr (S::PARTS == 2) {
      mma_3xtf32(hi0, lo0, b_addr, 0);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<BN>::bf16_ss(acc, desc_sw128(a_addr + 32 * ks),
                           desc_sw128(b_addr + 32 * ks));
    }
    wgmma_commit();
    on_tile(tile_a, kt);  // while the tensor cores run
    // One group stays in flight.  The one before it is done: the previous
    // tile's last, so its stage goes back to the producer (and for f32 the
    // registers of its A fragments may be written again).
    wgmma_wait<1>();
    if constexpr (S::PARTS == 2) {
      keep_alive(hi1);
      keep_alive(lo1);
    }
    if (kt > 0) mbar_arrive(&s.empty[prev]);
    if constexpr (S::PARTS == 2) {  // the tile's second half, k 16..31
      load_split(tile_a, 2, hi1, lo1);
      wgmma_fence();
      mma_3xtf32(hi1, lo1, b_addr, 2);
      wgmma_commit();
      wgmma_wait<1>();
      keep_alive(hi0);
      keep_alive(lo0);
    }
    prev = st;
    if (++st == FG_STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  if constexpr (S::PARTS == 2) {
    keep_alive(hi1);
    keep_alive(lo1);
  }
  fence_operands(acc);
  mbar_arrive(&s.empty[prev]);
}

// Synchronises the consumer threads (the producer warp has left).
__device__ __forceinline__ void fg_consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(FG_CONSUMERS) : "memory");
}

// Host side: the operands without fg_operands' conditions on the rows: any
// n >= 1 (TMA fills the rows of a box past n with zeros), A read in boxes
// of a_rows rows, bn 64 or 96.  Arguments, the scratch and the return value
// are fg_operands'.
template <typename T>
int fg_operands_any_rows(const void* a, int a_rows, const void* w, int w_trans,
                         void* w_prep, int n, int kdim, int m, int bn,
                         CUtensorMap* map_a, CUtensorMap* map_b,
                         CUtensorMap* map_b_lo, cudaStream_t st) {
  constexpr int PARTS = Operand<T>::PARTS;
  const bool bf16 = sizeof(T) == 2;
  if ((bn != 64 && bn != 96) || m <= 0 || m % bn || kdim <= 0 ||
      kdim % 128 || n <= 0)
    return -1;
  const bool prep = PARTS == 2 || !w_trans;
  if (prep && w_prep == nullptr) return -1;
  T* hi = prep ? static_cast<T*>(w_prep) : nullptr;
  T* lo = PARTS == 2 ? hi + (size_t)m * kdim : nullptr;
  const void* b_hi = prep ? static_cast<const void*>(hi) : w;
  const void* b_lo = lo != nullptr ? static_cast<const void*>(lo) : b_hi;
  if (!hopper::make_tile_map(map_a, a, bf16, n, kdim, a_rows) ||
      !hopper::make_tile_map(map_b, b_hi, bf16, m, kdim, bn) ||
      !hopper::make_tile_map(map_b_lo, b_lo, bf16, m, kdim, bn))
    return -2;
  if (prep)
    prep_weight_kernel<T><<<dim3(kdim / 32, m / 32), dim3(32, 8), 0, st>>>(
        static_cast<const T*>(w), w_trans, kdim, m, hi, lo);
  return 0;
}

// Host side: the operands as the mainloop reads them.  A (n, kdim) row-major
// at `a`; B the logical (kdim, m) weight at `w` (stored (m, kdim) when
// w_trans), written K-major into w_prep by prep_weight_kernel on `st` unless
// it is a bf16 (m, kdim) tensor, which is K-major as it is.  w_prep holds
// (2, m, kdim) f32 (hi, lo) or (m, kdim) bf16.  Returns 0, -1 for arguments
// the kernels do not take (nothing launched), or -2 when a TMA descriptor
// cannot be encoded.
template <typename T>
int fg_operands(const void* a, const void* w, int w_trans, void* w_prep, int n,
                int kdim, int m, int k_eff, int bn, CUtensorMap* map_a,
                CUtensorMap* map_b, CUtensorMap* map_b_lo, cudaStream_t st) {
  if (fg_smem_or_refuse<T>(bn) < 0 || n % FG_BM || k_eff % FG_BM ||
      k_eff <= 0 || n % k_eff)
    return -1;
  return fg_operands_any_rows<T>(a, FG_BM, w, w_trans, w_prep, n, kdim, m, bn,
                                 map_a, map_b, map_b_lo, st);
}

// Lets `kernel` take the whole shared-memory limit, once per device;
// `allowed` is the caller's set of devices done (one static per kernel
// instantiation).  Returns a CUDA error code.
inline int fg_allow_smem(const void* kernel, unsigned& allowed) {
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;  // 0: every launch
  if (allowed & bit) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FG_SMEM_LIMIT);
  if (err == cudaSuccess) allowed |= bit;
  return static_cast<int>(err);
}

}  // namespace fewbit
