// What the tensor-core flash attention kernels share (flash_forward.cu: F1;
// flash_backward.cu: F2 and F3): the block and tile shapes, the f32
// producer's pieces (the raw copy of a 64-row tile with cp.async, its TF32
// split in place, the transposed and k-permuted copy of the split planes),
// the product whose A operand is an accumulator fragment held in registers,
// the 4-D tensor map of an operand over its own strides, and the dynamic
// shared memory a kernel is allowed once per device.
//
// Layout: a block owns HB_BLOCK rows of its own side and loops over HB_TILE
// rows of the other side.  An f32 operand tile is kept as TF32 hi and lo
// planes of 64 rows x 64 floats, each two sub-tiles of 32 floats a row
// (128 bytes, swizzled as TMA would write them), K-major.
#pragma once

#include "flash_params.cuh"
#include "hopper_gemm.cuh"

namespace fewbit {
namespace {

constexpr int HB_BLOCK = 128;      // rows of a block's own side
constexpr int HB_TILE = 64;        // rows of a looped tile
constexpr int HB_CONSUMERS = 256;  // two consumer warpgroups
constexpr int HB_PRODUCERS = 128;  // one producer warpgroup
constexpr int HB_THREADS = HB_CONSUMERS + HB_PRODUCERS;
constexpr int HB_SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr float LOG2E = 1.4426950408889634f;

// Per element type, at head dimension D: the 128-byte sub-tiles of a row,
// the parts of a B operand (f32: TF32 hi and lo), wgmma k steps over 64
// elements, and the bytes of a plane, of the block's own rows, of a
// sub-tile of either, and of a ring stage of two operands.
template <typename T, int D>
struct HbShape {
  static_assert(D == 64, "other head dimensions need a tile layout of "
                         "their own");
  static constexpr int ELT = sizeof(T);
  static constexpr bool BF16 = ELT == 2;
  static constexpr int SUB = D * ELT / hopper::ROW_BYTES;
  static constexpr int PARTS = Operand<T>::PARTS;
  static constexpr int KSTEPS = HB_TILE * ELT / 32;
  static constexpr int TILE_BYTES = HB_TILE * D * ELT;  // one plane
  static constexpr int RES_BYTES = HB_BLOCK * D * ELT;
  static constexpr int RES_SUB_BYTES = HB_BLOCK * hopper::ROW_BYTES;
  static constexpr int TILE_SUB_BYTES = HB_TILE * hopper::ROW_BYTES;
  static constexpr int STAGE_BYTES = 2 * PARTS * TILE_BYTES;
};

// Byte offset of the 16-byte chunk c16 (four floats) of row `row` in a
// K-major plane of 64 rows x 64 floats: two sub-tiles of 32 floats a row,
// swizzled as TMA would.
__device__ __forceinline__ int plane_chunk(int row, int c16) {
  return (c16 >> 3) * (HB_TILE * hopper::ROW_BYTES) +
         row * hopper::ROW_BYTES + (((c16 & 7) ^ (row & 7)) << 4);
}

constexpr int HB_PLANE = HB_TILE * 64 * 4;  // bytes of an f32 plane

// The f32 producer, first half: tile rows l0 .. l0 + 63 of the head at `src`
// copied raw (cp.async, 16 bytes a chunk, nothing held in registers while
// they fly) to where the lo plane at `planes` + HB_PLANE will lie.  Rows
// past n_rows arrive as zeros.
__device__ __forceinline__ void fetch_tile(uint8_t* planes, const float* src,
                                           long long stride_s, int l0,
                                           int n_rows, int ptid) {
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int chunk = ptid + HB_PRODUCERS * it;
    const int row = chunk >> 4, c16 = chunk & 15;
    const bool in = l0 + row < n_rows;
    const float* from = in ? src + (l0 + row) * stride_s + 4 * c16 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     hopper::smem_u32(planes + HB_PLANE +
                                      plane_chunk(row, c16))),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Second half, once the thread's own copies have landed: each chunk split
// in place into the TF32 hi plane at `planes` and the lo plane one plane on,
// K-major.
__device__ __forceinline__ void split_fetched(uint8_t* planes, int ptid) {
#pragma unroll 4
  for (int it = 0; it < 8; ++it) {
    const int chunk = ptid + HB_PRODUCERS * it;
    const int off = plane_chunk(chunk >> 4, chunk & 15);
    const float4 v = *reinterpret_cast<const float4*>(planes + HB_PLANE + off);
    uint4 hi, lo;
    hopper::split_tf32(v.x, hi.x, lo.x);
    hopper::split_tf32(v.y, hi.y, lo.y);
    hopper::split_tf32(v.z, hi.z, lo.z);
    hopper::split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(planes + off) = hi;
    *reinterpret_cast<uint4*>(planes + HB_PLANE + off) = lo;
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
// them) transposed, out[d][permuted_k(row)], again as hi and lo planes of 64
// rows (d) x 64 floats, K-major for a product that contracts over the
// looped rows.  A warp's lanes take 32 different rows, so its 16-byte reads
// and its stores of one d are free of bank conflicts.
__device__ __forceinline__ void transpose_planes(uint8_t* planes,
                                                 const uint8_t* src,
                                                 int ptid) {
  const int w = ptid >> 5, lane = ptid & 31;
#pragma unroll 2
  for (int it = 0; it < 8; ++it) {
    const int rr = lane + 32 * (it & 1), c16 = 4 * w + (it >> 1);
    const int from = plane_chunk(rr, c16);
    const uint4 hi = *reinterpret_cast<const uint4*>(src + from);
    const uint4 lo = *reinterpret_cast<const uint4*>(src + HB_PLANE + from);
    const uint32_t his[4] = {hi.x, hi.y, hi.z, hi.w};
    const uint32_t los[4] = {lo.x, lo.y, lo.z, lo.w};
    const int kcol = permuted_k(rr);
    uint8_t* sub = planes + (kcol >> 5) * (HB_TILE * hopper::ROW_BYTES);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = hopper::swizzled_offset(4 * c16 + i, kcol & 31, 4);
      *reinterpret_cast<uint32_t*>(sub + off) = his[i];
      *reinterpret_cast<uint32_t*>(sub + HB_PLANE + off) = los[i];
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32: acc += v B, v a 64 x 64 accumulator fragment over the looped rows and
// B the hi and lo planes at `planes` that transpose_planes wrote, as three
// TF32 products.  Accumulator columns 2 t, 2 t + 1 of step j are the A
// fragment's columns t, t + 4: the order transpose_planes wrote B's k in.
// Its 64 fragment registers are free again when it returns.
template <int D>
__device__ __forceinline__ void tf32_rows_product(float (&acc)[D / 2],
                                                  const float (&v)[32],
                                                  uint32_t planes) {
  using namespace hopper;
  uint32_t vh[8][4], vl[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(v[4 * j + 2 * (r & 1) + (r >> 1)], vh[j][r], vl[j][r]);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t b = planes + (j / 4) * (HB_TILE * ROW_BYTES) + 32 * (j % 4);
    const uint64_t bh = desc_sw128(b);
    const uint64_t bl = desc_sw128(b + HB_PLANE);
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

// The 4-D map of one operand: boxes of box_rows rows of one head.  A
// dimension of one element takes a stride TMA accepts whatever the tensor
// says.  False when the base or a stride is not 16-byte aligned, or the
// encode fails.
template <typename T>
bool operand_map(CUtensorMap* map, const void* ptr, const Strides& st, int b,
                 int h, int s, uint32_t box_rows) {
  const long long elt = sizeof(T), unit = 64 * elt;
  const long long sb = b > 1 ? st.b * elt : unit;
  const long long sh = h > 1 ? st.h * elt : unit;
  const long long ss = s > 1 ? st.s * elt : unit;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || sb <= 0 || sb % 16 ||
      sh <= 0 || sh % 16 || ss <= 0 || ss % 16)
    return false;
  return hopper::make_tile_map_4d(map, ptr, sizeof(T) == 2, b, h, s, 64, sb,
                                  sh, ss, box_rows);
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
}  // namespace fewbit
