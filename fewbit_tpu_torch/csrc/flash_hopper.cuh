// What the tensor-core flash attention kernels share (flash_forward.cuh: F1;
// flash_backward.cuh: F2 and F3): the block and tile shapes per head
// dimension, the dynamic shared memory of each instantiation, the f32
// producer's pieces (the raw copy of a looped tile with cp.async, its TF32
// split in place, the transposed and k-permuted copy of the split planes),
// the product whose A operand is an accumulator fragment held in registers,
// the 4-D tensor map of an operand over its own strides, and the dynamic
// shared memory a kernel is allowed once per device.
//
// Layout: a block owns 64 rows of its own side per consumer warpgroup and
// loops over TILE rows of the other side.  An operand tile is kept in
// sub-tiles of RB-byte rows (RB the largest of 128, 64 and 32 that divides
// a row's D ELT bytes), swizzled as TMA writes them with the swizzle of
// that width, K-major over d.  An f32 looped tile is kept as TF32 hi and lo
// planes of TILE rows x D floats in the same sub-tiles.
//
// The kernels are instantiated at every multiple of 16 up to 128; the
// wrappers (ops/kernels.py) give any other head dimension up to 128
// zero-padded copies of the next multiple's width.  Every multiple of 128
// above 128 runs on the wide kernels (flash_forward_wide.cu,
// flash_backward_wide.cuh), whose number of 128-column chunks is a launch
// argument: below, hb_wide_fwd and wide_fwd_smem (F1) and hb_wide_bwd
// and wide_bwd_smem (F2 and F3).
#pragma once

#include "flash_params.cuh"
#include "hopper_gemm.cuh"

namespace fewbit {
namespace {

constexpr int HB_PRODUCERS = 128;  // one producer warpgroup
constexpr int HB_SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr float LOG2E = 1.4426950408889634f;

// The kernels, as hb_tiles and the entry points number them.
constexpr int FLASH_F1 = 0, FLASH_F2 = 1, FLASH_F3 = 2;

// The shape of a block of kernel `kernel` at head dimension d (an
// instantiation): its consumer warpgroups (64 own rows each), the rows of a
// looped tile and the stages of its ring.  Up to d = 64: two warpgroups
// (128 own rows), 64-row tiles, four stages in bf16; in f32 two stages in
// F1 and one in F2 and F3 (their TF32 planes fill the block's shared
// memory at d = 64).  Above 64 the f32 planes of two warpgroups over
// 64-row tiles no longer fit: f32 takes one warpgroup and 32-row tiles,
// which at d = 128 bring its shared memory back to the budgets of d = 64,
// and a consumer thread may have 255 registers for its d / 2 of each
// accumulator.  bf16 F2 holds dK and dV (d registers) beside S, dP and
// their packed fragments: at d = 128 in a 384-thread block (168 registers
// a thread by its launch bound) ptxas reported 660 bytes of spills, so
// above 64 it runs its two consumer warpgroups without the producer
// (hb_self_fed): 256 threads, 255 registers.  bf16 F1 above 64 keeps the
// shapes of 64 and its producer warp, one block an SM (288 threads, 168
// registers: o is at most 64 of them).
struct HbTiles {
  int wgs, tile, stages;
};
constexpr HbTiles hb_tiles(int kernel, bool bf16, int d) {
  if (d > 64 && !bf16) return {1, 32, kernel == FLASH_F1 ? 2 : 1};
  return {2, 64, bf16 ? 4 : (kernel == FLASH_F1 ? 2 : 1)};
}

// Whether kernel `kernel` at the instantiation d runs without a producer
// warpgroup, a consumer warp issuing the loads: bf16 F2 above 64.  (bf16
// F3 so fed took 1.03 to 1.35 times its time with the producer on an
// NVIDIA H100 80GB HBM3, and bf16 F1 above 64 so fed, each warpgroup
// running a tile's softmax while the tensor cores ran P V of the tile
// before, 1.01 to 1.13 times.)
__host__ __device__ constexpr bool hb_self_fed(int kernel, bool bf16, int d) {
  return kernel == FLASH_F2 && bf16 && d > 64;
}

// Dynamic shared memory of an F1 block: Q (f32: its hi and lo planes), the
// ring (K and V tiles; for f32 K's hi and lo planes and V's transposed
// ones), the f32 staging of V, the per-tile ids, the barriers and the slack
// that aligns it all to 1024 bytes.  f32 takes 230,984 of the 232,448
// bytes a block may have at d = 64 and 230,728 at d = 128.
constexpr int ff_smem(bool bf16, int d) {
  const HbTiles t = hb_tiles(FLASH_F1, bf16, d);
  const int elt = bf16 ? 2 : 4, parts = bf16 ? 1 : 2;
  const int tile = t.tile * d * elt;
  return parts * 64 * t.wgs * d * elt + t.stages * 2 * parts * tile +
         (bf16 ? 0 : 2 * tile) + t.stages * (t.tile + 4) * 4 +
         (2 * t.stages + 1) * 8 + 1024;
}

// Dynamic shared memory of an F2 (dkv) or F3 block: the block's own two
// operands, the ring of the first products' B tiles, the transposed planes
// of the second products (f32 only: two operands in F2, one in F3), the
// per-tile row values, the barriers and the slack that aligns it all to
// 1024 bytes.  A second f32 stage of F2 at d = 64 (another 64 KB) would not
// fit.
constexpr int hb_smem(bool bf16, bool dkv, int d) {
  const HbTiles t = hb_tiles(dkv ? FLASH_F2 : FLASH_F3, bf16, d);
  const int elt = bf16 ? 2 : 4, parts = bf16 ? 1 : 2;
  const int tile = t.tile * d * elt;
  return 2 * 64 * t.wgs * d * elt + t.stages * 2 * parts * tile +
         (bf16 ? 0 : (dkv ? 2 : 1) * 2 * tile) +
         (bf16 ? t.stages : 2) * (3 * t.tile + 4) * 4 + 128 + 1024;
}

constexpr int FLASH_CHUNK = 128;  // columns of a wide kernel's chunk

// The wide forward (flash_forward_wide.cu): a head dimension d = 128 c
// above 128 as c chunks of 128 columns, each laid out as head dimension
// 128's operands (sub-tiles of 128-byte rows, the 128-byte swizzle).  A
// block owns 64 query rows per consumer warpgroup and NJ = 2 chunks of o's
// columns (128 registers of o a thread): ceil(c / 2) blocks per row tile,
// one at c = 2.  S contracts over all of d, chunk by chunk in the order
// 0 .. c - 1, so that the blocks of a row tile hold the same S, m, l and
// lse to the bit.  Where they fit beside the ring (RES) the block's query
// rows are loaded once and stay resident; else a ring stage carries their
// chunk beside K's.
// - bf16: no producer warps (256 threads, 255 registers; a consumer warp
//   issues every TMA load), two warpgroups over 64-row kv tiles.  The ring
//   carries, per kv tile, K's c chunks and then V's chunks of the block's
//   columns, a chunk a stage (16 KB): eight stages, two tiles at c = 2,
//   beside the resident rows (32 KB a chunk) up to c = 4 (six stages
//   there: a step's c + 2 chunks must fit, as a step is one wgmma group);
//   above, four stages that each hold the query rows' chunk too, each
//   retired before the next is waited for.
// - f32: one consumer warpgroup over 32-row kv tiles and a producer
//   warpgroup (256 threads, 255 registers) that splits K's chunks into TF32
//   hi and lo planes in the ring (two stages) and writes V's chunks of the
//   block's columns into part 2 as transposed planes, a slot a chunk,
//   through one staging pair of planes.  The query rows are resident at
//   c = 2 (64 KB); above, a stage carries their chunk raw.
struct HbWideFwd {
  int tile;    // rows of a kv tile
  int stages;  // of the ring
  int nj;      // chunks of o a block owns
  bool res;    // the query rows resident (else a stage carries their chunk)
};
__host__ __device__ constexpr HbWideFwd hb_wide_fwd(bool bf16, int chunks) {
  if (bf16)
    return chunks <= 4 ? HbWideFwd{64, chunks <= 3 ? 8 : 6, 2, true}
                       : HbWideFwd{64, 4, 2, false};
  return {32, 2, 2, chunks == 2};
}

// Dynamic shared memory of a wide F1 block of `chunks` chunks: the
// resident query rows (RES), the ring (a stage: the query rows' chunk
// unless resident, and a chunk of K or V, f32's K as TF32 hi and lo
// planes), f32's part 2 (NJ slots of V's transposed hi and lo planes) and
// staging of V, the barriers and 1024 bytes of alignment slack.
constexpr int wide_fwd_smem(bool bf16, int chunks) {
  const HbWideFwd w = hb_wide_fwd(bf16, chunks);
  const int elt = bf16 ? 2 : 4, parts = bf16 ? 1 : 2;
  const int q_chunk = (bf16 ? 128 : 64) * FLASH_CHUNK * elt;
  const int loop = parts * w.tile * FLASH_CHUNK * elt;
  return (w.res ? chunks * q_chunk : 0) +
         w.stages * ((w.res ? 0 : q_chunk) + loop) +
         (bf16 ? 0 : (w.nj + 1) * loop) + (2 * w.stages + 2 * w.nj + 1) * 8 +
         1024;
}

// The wide backward (flash_backward_wide.cuh), F2 and F3 at d = 128 c: a
// block owns 64 rows of its own side (k and v rows in F2, q and dO rows in
// F3) and NJ chunks of 128 columns of its outputs, so the grid holds
// ceil(c / NJ) blocks per row tile.  Its two consumer warpgroups share the
// 64 rows and split the work by operand: in F2 the first computes S^T and
// P and sums dV, the second dP^T and dS and sums dK, each over the block's
// chunks; in F3 the first computes S and P, the second dP and dS, and each
// sums one half (64 columns) of every chunk of dQ the block owns.  P (and
// in F3 dS) passes between them through shared memory, as f32 fragments.
// Per looped tile of TILE rows a ring of STAGES stages carries the first
// products' operands over all of d, SLICE columns a stage, in the order
// 0 .. d - 1 (every block of a row tile so holds the same P and dS to the
// bit); the second products read the looped tile's chunks of the block's
// columns.  ptxas gives every thread of a block the launch's register
// budget (setmaxnreg does not raise it for the consumers' code), and a
// block of nine or twelve warps puts three on one of the SM's four
// register files: 168 registers a thread, eight warps 255.
// - bf16: no producer warps (256 threads, 255 registers: F2's 128 of dV or
//   dK over two chunks beside a 64 x 64 first product), one consumer
//   thread issues every TMA load; NJ = 2, one block a row tile at c = 2;
//   64-row tiles (the first products at N = 64), a stage one chunk.  At
//   c = 2 (RES) the block's own rows are loaded once and stay resident
//   (64 KB), a stage holds only the looped tile's chunk, and the second
//   products read the block's chunks from the ring: four stages, two
//   tiles.  Above, a stage carries the own rows' chunk beside the looped
//   one, and the block's chunks come again by TMA into slots of their own
//   (part 2): two stages.  There F3, whose halves of dQ take 32 registers
//   a chunk, owns NJ = 4 (one block a row tile up to c = 4): every block
//   streams the own rows and computes the first products again, so fewer
//   blocks a row tile move fewer bytes from L2.
// - f32: a producer warpgroup (384 threads, 168 registers), which fetches
//   the looped slices, splits them into TF32 hi and lo planes and writes
//   the block's chunks of the second products' operands into part 2 as
//   transposed planes; 32-row tiles, four stages of 32 columns (the own
//   rows' raw slice by TMA and the looped planes, 32 KB).  168 registers
//   hold one chunk of dK or dV beside a first product: F2 NJ = 1 (at c = 2
//   the two blocks of a row tile each compute the first products), F3,
//   whose halves of dQ take 32 registers a chunk, NJ = 2.
struct HbWideBwd {
  int tile;       // rows of a looped tile
  int slice;      // columns of d a stage carries
  int stages;     // of the ring
  int nj;         // output chunks a block owns
  bool res;       // the own rows resident (else a stage carries their slice)
  int producers;  // threads of the producer warpgroup (bf16: none)
};
constexpr HbWideBwd hb_wide_bwd(bool bf16, bool dkv, int chunks) {
  if (bf16)
    return chunks == 2 ? HbWideBwd{64, FLASH_CHUNK, 4, 2, true, 0}
                       : HbWideBwd{64, FLASH_CHUNK, 2, dkv ? 2 : 4, false, 0};
  return {32, 32, 4, dkv ? 1 : 2, false, HB_PRODUCERS};
}

// Dynamic shared memory of a wide F2 (dkv) or F3 block of `chunks` chunks:
// the resident own rows (RES), the ring (a stage: the own rows' slice of
// both operands unless resident, and the looped tile's, f32 as TF32 hi and
// lo planes), part 2 (unless RES: NJ slots of the second products'
// operands, F2 two and F3 one, f32 as transposed hi and lo planes), the f32
// exchange of P (and dS in F3), the barriers and 1024 bytes of alignment
// slack.
constexpr int wide_bwd_smem(bool bf16, bool dkv, int chunks) {
  const HbWideBwd w = hb_wide_bwd(bf16, dkv, chunks);
  const int elt = bf16 ? 2 : 4, parts = bf16 ? 1 : 2;
  const int own_slice = 64 * w.slice * elt;
  const int loop_slice = parts * w.tile * w.slice * elt;
  const int stage = (w.res ? 0 : 2 * own_slice) + 2 * loop_slice;
  const int slot = (dkv ? 2 : 1) * parts * w.tile * FLASH_CHUNK * elt;
  return (w.res ? 2 * 64 * FLASH_CHUNK * chunks * elt : 0) +
         w.stages * stage + (w.res ? 0 : w.nj * slot) +
         (dkv ? 1 : 2) * 64 * w.tile * 4 + (2 * w.stages + 2 * w.nj + 5) * 8 +
         1024;
}

// Per element type, at head dimension D, for kernel KERNEL: the block's
// warpgroups and rows, the looped tile's rows and the ring's stages
// (hb_tiles); the bytes of a sub-tile row (the swizzle) and the sub-tiles
// of a row; the parts of a B operand (f32: TF32 hi and lo); wgmma k steps
// (32 bytes: k16 in bf16, k8 in tf32) over d, over the looped rows, and
// within a sub-tile row; and the bytes of a plane, of the block's own rows,
// of a sub-tile of either, and of a ring stage of two operands.
template <typename T, int D, int KERNEL>
struct HbShape {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128,
                "the kernels are instantiated at every multiple of 16 up "
                "to 128");
  static constexpr int ELT = sizeof(T);
  static constexpr bool BF16 = ELT == 2;
  static constexpr HbTiles TILES = hb_tiles(KERNEL, BF16, D);
  static constexpr int WGS = TILES.wgs;
  static constexpr int BLOCK = 64 * WGS;  // rows of a block's own side
  static constexpr int TILE = TILES.tile;  // rows of a looped tile
  static constexpr int STAGES = TILES.stages;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int RB = D * ELT % 128 == 0 ? 128
                            : D * ELT % 64 == 0 ? 64
                                                : 32;
  static constexpr int SUB = D * ELT / RB;
  static constexpr int PARTS = Operand<T>::PARTS;
  static constexpr int KD = D * ELT / 32;
  static constexpr int KT = TILE * ELT / 32;
  static constexpr int KSUB = RB / 32;
  static constexpr int TILE_BYTES = TILE * D * ELT;  // one plane
  static constexpr int RES_BYTES = BLOCK * D * ELT;
  static constexpr int RES_SUB_BYTES = BLOCK * RB;
  static constexpr int TILE_SUB_BYTES = TILE * RB;
  static constexpr int STAGE_BYTES = 2 * PARTS * TILE_BYTES;
  // The leading byte offset of a looped tile read MN-major (bf16): its next
  // sub-tile of columns, where a row has more than one.
  static constexpr uint32_t MN_LBO = SUB > 1 ? TILE_SUB_BYTES : 16;
};

// log2 of a power of two: the producer's index arithmetic takes shifts and
// masks, as signed division by a constant costs it registers it does not
// have (40 a thread).
__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// Byte offset of the 16-byte chunk c16 (four floats) of row `row` in a
// K-major f32 plane of TILE rows: sub-tiles of RB bytes a row, swizzled as
// TMA would with the swizzle of that width.
template <int TILE, int RB>
__device__ __forceinline__ int plane_chunk(int row, int c16) {
  constexpr int CPR = RB / 16;  // chunks of a sub-tile row
  return (c16 >> ilog2(CPR)) * (TILE * RB) + row * RB +
         ((((c16 & (CPR - 1)) ^ ((row * RB) >> 7)) & (CPR - 1)) << 4);
}

// The row and chunk of the producer's chunk `chunk` of a plane, row-major
// over rows of D / 4 chunks: a shift and a mask where D / 4 is a power of
// two, else an unsigned division (a multiply-high).
template <int D>
__device__ __forceinline__ void plane_row_chunk(int chunk, int& row,
                                                int& c16) {
  constexpr int ROW_CHUNKS = D / 4;
  if constexpr ((ROW_CHUNKS & (ROW_CHUNKS - 1)) == 0) {
    row = chunk >> ilog2(ROW_CHUNKS);
    c16 = chunk & (ROW_CHUNKS - 1);
  } else {
    row = static_cast<int>(static_cast<unsigned>(chunk) / ROW_CHUNKS);
    c16 = chunk - row * ROW_CHUNKS;
  }
}

// The f32 producer, first half: tile rows l0 .. l0 + TILE - 1 of the head
// at `src` copied raw (cp.async, 16 bytes a chunk, nothing held in
// registers while they fly) to where the lo plane at `planes` + TILE D 4
// will lie.  Rows past n_rows arrive as zeros.
template <int TILE, int D, int RB>
__device__ __forceinline__ void fetch_tile(uint8_t* planes, const float* src,
                                           long long stride_s, int l0,
                                           int n_rows, int ptid) {
  constexpr int PLANE = TILE * D * 4, ROW_CHUNKS = D / 4;
#pragma unroll
  for (int it = 0; it < TILE * ROW_CHUNKS / HB_PRODUCERS; ++it) {
    int row, c16;
    plane_row_chunk<D>(ptid + HB_PRODUCERS * it, row, c16);
    const bool in = l0 + row < n_rows;
    const float* from = in ? src + (l0 + row) * stride_s + 4 * c16 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     hopper::smem_u32(planes + PLANE +
                                      plane_chunk<TILE, RB>(row, c16))),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Second half, once the thread's own copies have landed: each chunk split
// in place into the TF32 hi plane at `planes` and the lo plane one plane on,
// K-major.
template <int TILE, int D, int RB>
__device__ __forceinline__ void split_fetched(uint8_t* planes, int ptid) {
  constexpr int PLANE = TILE * D * 4, ROW_CHUNKS = D / 4;
#pragma unroll 4
  for (int it = 0; it < TILE * ROW_CHUNKS / HB_PRODUCERS; ++it) {
    int row, c16;
    plane_row_chunk<D>(ptid + HB_PRODUCERS * it, row, c16);
    const int off = plane_chunk<TILE, RB>(row, c16);
    const float4 v = *reinterpret_cast<const float4*>(planes + PLANE + off);
    uint4 hi, lo;
    hopper::split_tf32(v.x, hi.x, lo.x);
    hopper::split_tf32(v.y, hi.y, lo.y);
    hopper::split_tf32(v.z, hi.z, lo.z);
    hopper::split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(planes + off) = hi;
    *reinterpret_cast<uint4*>(planes + PLANE + off) = lo;
  }
}

// Column of the transposed tile that holds looped row rr: within each group
// of eight rows (one tf32 wgmma step), row a sits where the A fragment built
// from an accumulator fragment expects it: fragment column kappa holds
// accumulator column 2 kappa (kappa < 4) or 2 (kappa - 4) + 1.
__device__ __forceinline__ int permuted_k(int rr) {
  const int a = rr & 7;
  return (rr & ~7) + ((a & 1) ? 4 + (a >> 1) : (a >> 1));
}

// The f32 producer: the hi and lo planes at `src` (as split_fetched wrote
// them) transposed, out[d][permuted_k(row)], again as hi and lo planes of D
// rows (d) x TILE floats in sub-tiles of 32 floats (128 bytes) a row,
// K-major for a product that contracts over the looped rows; the lo plane
// DST_PLANE bytes after the hi one (the wide backward writes a slice of
// columns into planes of 128 rows).  A warp's lanes take 32 different
// rows, so its 16-byte reads and its stores of one d are free of bank
// conflicts.
template <int TILE, int D, int RB, int DST_PLANE = TILE * D * 4>
__device__ __forceinline__ void transpose_planes(uint8_t* planes,
                                                 const uint8_t* src,
                                                 int ptid) {
  constexpr int PLANE = TILE * D * 4;
  constexpr int GROUPS = TILE / 32, CHUNKS = D / 16;  // a warp's
  const int w = ptid >> 5, lane = ptid & 31;
#pragma unroll 2
  for (int it = 0; it < GROUPS * CHUNKS; ++it) {
    const int rr = lane + 32 * (it & (GROUPS - 1));
    const int c16 = CHUNKS * w + (it >> ilog2(GROUPS));
    const int from = plane_chunk<TILE, RB>(rr, c16);
    const uint4 hi = *reinterpret_cast<const uint4*>(src + from);
    const uint4 lo = *reinterpret_cast<const uint4*>(src + PLANE + from);
    const uint32_t his[4] = {hi.x, hi.y, hi.z, hi.w};
    const uint32_t los[4] = {lo.x, lo.y, lo.z, lo.w};
    const int kcol = permuted_k(rr);
    uint8_t* sub = planes + (kcol >> 5) * (D * hopper::ROW_BYTES);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = hopper::swizzled_offset(4 * c16 + i, kcol & 31, 4);
      *reinterpret_cast<uint32_t*>(sub + off) = his[i];
      *reinterpret_cast<uint32_t*>(sub + DST_PLANE + off) = los[i];
    }
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: exp2f adds a fix-up for results
// below 2^-126, which P does not need).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32: acc += v B, v a 64 x TILE accumulator fragment over the looped rows
// and B the hi and lo planes at `planes` that transpose_planes wrote, as
// three TF32 products.  Accumulator columns 2 t, 2 t + 1 of step j are the A
// fragment's columns t, t + 4: the order transpose_planes wrote B's k in.
// Its fragment registers are free again when it returns.
template <int D, int TILE>
__device__ __forceinline__ void tf32_rows_product(float (&acc)[D / 2],
                                                  const float (&v)[TILE / 2],
                                                  uint32_t planes) {
  using namespace hopper;
  constexpr int STEPS = TILE / 8, PLANE = TILE * D * 4;
  uint32_t vh[STEPS][4], vl[STEPS][4];
#pragma unroll
  for (int j = 0; j < STEPS; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(v[4 * j + 2 * (r & 1) + (r >> 1)], vh[j][r], vl[j][r]);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const uint32_t b = planes + (j / 4) * (D * ROW_BYTES) + 32 * (j % 4);
    const uint64_t bh = desc_sw128(b);
    const uint64_t bl = desc_sw128(b + PLANE);
    Wgmma<D>::tf32_rs(acc, vh[j], bh);
    Wgmma<D>::tf32_rs(acc, vh[j], bl);
    Wgmma<D>::tf32_rs(acc, vl[j], bh);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep_alive(vh);
  keep_alive(vl);
  fence_operands(acc);
}

// f32, the wide kernels' first products over KD k steps of 8 columns (a
// chunk of 128 in the forward, a slice of 32 in the backward): x += A B^T,
// A the warpgroup's own rows, raw f32 at `own` as TMA wrote them in
// sub-tiles of BLOCK rows of 128 bytes, split into TF32 hi and lo A
// fragments in registers CH k steps at a time (the next CH steps' loaded
// while these multiply), B the looped tile's K-major hi and lo planes at
// `b` (the lo plane TILE rows of 32 KD bytes on).  rloc is the thread's
// first row in the block.
template <int TILE, int BLOCK, int KD, int CH>
__device__ __forceinline__ void tf32_chunk_products(float (&x)[TILE / 2],
                                                    const uint8_t* own,
                                                    uint32_t b, int rloc,
                                                    int tq) {
  using namespace hopper;
  constexpr int KSUB = 4, OWN_SUB = BLOCK * 128;
  constexpr int PLANE = TILE * 32 * KD, TSUB = TILE * 128;
  uint32_t fh[2][CH][4], fl[2][CH][4];
  auto load = [&](int c) {
#pragma unroll
    for (int q = 0; q < CH; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ks = CH * c + q;
        const uint32_t off =
            (ks / KSUB) * OWN_SUB +
            swizzled_offset(rloc + 8 * (e & 1),
                            8 * (ks % KSUB) + tq + 4 * (e >> 1), 4, 128);
        split_tf32(*reinterpret_cast<const float*>(own + off),
                   fh[c & 1][q][e], fl[c & 1][q][e]);
      }
  };
  load(0);
#pragma unroll
  for (int c = 0; c < KD / CH; ++c) {
    const int cur = c & 1;
    fence_operands(x);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int ks = CH * c + q;
      const uint32_t bb = b + (ks / KSUB) * TSUB + 32 * (ks % KSUB);
      const uint64_t bh = desc_sw(bb, 128), bl = desc_sw(bb + PLANE, 128);
      Wgmma<TILE>::tf32_rs(x, fh[cur][q], bh);
      Wgmma<TILE>::tf32_rs(x, fh[cur][q], bl);
      Wgmma<TILE>::tf32_rs(x, fl[cur][q], bh);
    }
    wgmma_commit();
    if (c < KD / CH - 1) load(c + 1);
    wgmma_wait<0>();
    keep_alive(fh[cur]);
    keep_alive(fl[cur]);
  }
  fence_operands(x);
}

// Whether every row of the warp and every row of a looped tile of TILE rows
// have one segment id: `one` holds, for each 32 rows of the tile, whether
// they share an id and which; rid the thread's two rows' ids.
template <int TILE>
__device__ __forceinline__ bool one_segment(const int* one,
                                            const int (&rid)[2]) {
  static_assert(TILE == 32 || TILE == 64, "one or two halves of 32");
  const bool tile_one =
      TILE == 64 ? one[0] && one[2] && one[1] == one[3] : one[0];
  return __all_sync(0xffffffffu,
                    tile_one && rid[0] == one[1] && rid[1] == one[1]);
}

// The same from the tile's TILE ids in shared memory, read by each warp
// itself (where no producer wrote the flags that one_segment reads).
template <int TILE>
__device__ __forceinline__ bool one_segment_read(const int* ids,
                                                 const int (&rid)[2]) {
  const int first = ids[0];
  bool same = rid[0] == first && rid[1] == first;
#pragma unroll
  for (int i = threadIdx.x & 31; i < TILE; i += 32)
    same = same && ids[i] == first;
  return __all_sync(0xffffffffu, same);
}

// 4 bytes from global `src` to shared `dst` by cp.async, zeros where !in
// (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// An arrival on `bar` once every cp.async this thread issued has landed;
// the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// Whether the looped tile has one segment id and every row of the warp
// has it too (one document, or no padding here): ids the thread's ids of
// the tile's columns (a warp holds every column), rid its rows'.
template <int N>
__device__ __forceinline__ bool one_segment_ids(const int (&ids)[N],
                                                const int (&rid)[2]) {
  const int first = __shfl_sync(0xffffffffu, ids[0], 0);
  bool same = rid[0] == first && rid[1] == first;
#pragma unroll
  for (int i = 0; i < N; ++i) same = same && ids[i] == first;
  return __all_sync(0xffffffffu, same);
}

// The 4-D map of one operand of head dimension d: boxes of box_rows rows of
// one head, rb bytes of d each.  A dimension of one element takes a stride
// TMA accepts whatever the tensor says.  False when the base or a stride is
// not 16-byte aligned, or the encode fails.
template <typename T>
bool operand_map(CUtensorMap* map, const void* ptr, const Strides& st, int b,
                 int h, int s, int d, uint32_t box_rows, uint32_t rb) {
  const long long elt = sizeof(T), unit = d * elt;
  const long long sb = b > 1 ? st.b * elt : unit;
  const long long sh = h > 1 ? st.h * elt : unit;
  const long long ss = s > 1 ? st.s * elt : unit;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || sb <= 0 || sb % 16 ||
      sh <= 0 || sh % 16 || ss <= 0 || ss % 16)
    return false;
  return hopper::make_tile_map_4d(map, ptr, sizeof(T) == 2, b, h, s, d, sb,
                                  sh, ss, box_rows, rb);
}

// Allows `kernel` `smem` bytes of dynamic shared memory on the current
// device, with all of an SM's unified memory that can be shared memory
// (two 84 KB blocks of F1 bf16 on one SM), once per device (`allowed`: a
// bit per device already done, kept by the caller per kernel).  Returns
// the CUDA error, 0 when allowed.
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, unsigned& allowed) {
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;  // 0: every launch
  if (!(allowed & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= bit;
  }
  return 0;
}

}  // namespace

// The launchers of each head dimension's instantiations, each in a source
// of its own so that they compile in parallel (flash_forward*.cu,
// flash_backward*.cu).  Each returns as its entry point does.
#define FEWBIT_FLASH_DECLARE_D(D)                                         \
  int flash_forward_d##D(const FlashParams& p, int b, bool bf16,          \
                         cudaStream_t st);                                 \
  int flash_backward_d##D(const FlashParams& p, int b, bool bf16, bool dkv, \
                          cudaStream_t st);
FEWBIT_FLASH_DECLARE_D(16)
FEWBIT_FLASH_DECLARE_D(32)
FEWBIT_FLASH_DECLARE_D(48)
FEWBIT_FLASH_DECLARE_D(64)
FEWBIT_FLASH_DECLARE_D(80)
FEWBIT_FLASH_DECLARE_D(96)
FEWBIT_FLASH_DECLARE_D(112)
FEWBIT_FLASH_DECLARE_D(128)
#undef FEWBIT_FLASH_DECLARE_D

// The wide kernels' launchers, at head dimension 128 chunks
// (flash_forward_wide.cu, flash_backward_wide.cu).
int flash_forward_wide(const FlashParams& p, int b, int chunks, bool bf16,
                       cudaStream_t st);
int flash_backward_wide(const FlashParams& p, int b, int chunks, bool bf16,
                        bool dkv, cudaStream_t st);

}  // namespace fewbit
