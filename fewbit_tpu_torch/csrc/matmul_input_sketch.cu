// Fused matmul + input countsketch: y = x @ w (+ b), the stride-partition
// countsketch sk[b] = sum_{r = b mod k_eff} sigma_r x_r, and optionally the
// f32 column sum of x.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_matmul_input_sketch
// (_matmul_input_sketch_kernel), the sketched-linear kernel of the attention
// q/k/v/output projections, forward on x and backward on dy with w^T and
// the column sum for db.
//
// What bounds it on this card: at the attention widths (N = 8192 rows,
// 768 -> 768) the product is 2 N K M = 9.7 GFLOP against about 50 MB of f32
// x and y (25 MB in bf16).  In bf16 the tensor cores (989 TFLOP/s) would
// take 10 us and device memory 8-17 us, so the kernel is bound by memory
// and by re-reading x and w tiles from L2.  f32 models multiply in f32:
// three TF32 products (hi hi, hi lo, lo hi) keep f32 accuracy at a third of
// the TF32 rate (495 / 3 TFLOP/s: 60 us), so there the tensor cores bound it.
// On an H100 SXM at 700 W it takes about 0.11 ms in f32 (half the 3xTF32
// rate) and 0.04 ms in bf16 (a quarter of the bf16 rate) at that shape.
//
// Design (Hopper, sm_90a):
// - A block owns one slab of k_eff / 128 bucket rows and one column tile of
//   y (the TPU kernel's slab-owner grid), and loops over the N / k_eff
//   passes itself: pass c computes the y tile at rows c k_eff + 128 s.
// - Operand tiles come by TMA (128-byte swizzle) into a ring of 4
//   shared-memory stages with a full and an empty mbarrier each; one
//   producer thread keeps the loads in flight.  Two consumer warpgroups (64
//   rows each) run wgmma with f32 accumulators in registers.
// - One wgmma group stays in flight while the next k tile's is issued; the
//   stage of the tile before goes back to the producer when its group
//   retires.
// - bf16: wgmma .bf16 with both operands from shared memory.  f32: 3xTF32.
//   A (x) is split in registers (hi = tf32(a), lo = tf32(a - hi)) and fed
//   to wgmma from registers, which saves the shared-memory round trip of a
//   staged split.  The compiler does not see that wgmma reads them after
//   issue, so each half of a k tile has fragment registers of its own,
//   kept alive until the wait that retires its group.  B comes pre-split:
//   wgmma .tf32 wants both operands K-major, so a prologue
//   (prep_weight_kernel in hopper_gemm.cuh) writes w_hi and w_lo, or for
//   bf16 the transposed weight of the backward, K-major into scratch; the
//   forward's bf16 weight (torch's (out, in)) is K-major as it is.
// - The sketch and the column sum come from the x tiles already in the
//   ring: each block owns the sketch columns [j K / J, (j + 1) K / J) of its
//   column tile j (J column tiles), adds sigma_r x_r of the raw operand to
//   an f32 accumulator in shared memory (written on pass 0, added after),
//   and writes each sketch element once at the end; the column sum is
//   per-slab partials of the same slice, summed in order by
//   sum_partials_kernel.  Every element has one owning thread: no atomics,
//   deterministic.  The read is SketchSlice (hopper_gemm.cuh), which
//   kernel 2' shares.  Where that slice does not fit shared memory, the
//   host (matmul_sketch_route in ops/kernels.py) chooses the separate pass
//   instead, from the shapes alone: input_sketch_kernel, launched after
//   the GEMM through its own entry point (fewbit_input_sketch, the
//   wrapper input_sketch), as kernel 2' launches it on its separate route.
//   Both routes write one column-sum partial per 128 buckets.
// - Tile width BN is 96 where it divides M, to fill the 132 SMs: at
//   768 -> 768 with k_eff 2048, 16 x 8 = 128 blocks (128-wide tiles would
//   give 96).  Elsewhere, or where the sketch slice does not fit at 96, 64.
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace fewbit {
namespace {

using hopper::ROW_BYTES;

constexpr int K1_BM = 128;         // rows of a block tile
constexpr int K1_STAGES = 4;       // depth of the TMA ring
constexpr int K1_CONSUMERS = 256;  // two consumer warpgroups
constexpr int K1_THREADS = K1_CONSUMERS + 32;  // and one producer warp
constexpr int K1_SMEM_LIMIT = 232448;  // dynamic shared memory of a block

// Dynamic shared memory of the GEMM kernel: the ring, the sketch slice
// (128 rows) and the column-sum rows (kcp = 0 on the separate route), the
// barriers and the slack that aligns the ring to 1024 bytes.  The host's
// route (_k1_smem in fewbit_tpu_torch/ops/kernels.py) computes the same;
// fewbit_matmul_sketch_smem exports this one so a test can compare them.
constexpr int k1_smem(int parts, int groups, int bn, int kcp) {
  return K1_STAGES * (K1_BM + parts * bn) * ROW_BYTES +
         (K1_BM + 2 * groups) * kcp * 4 + 2 * K1_STAGES * 8 + 1024;
}

template <typename T>
struct K1Params {
  const T* bias;
  const float* sigma;
  T* y;
  T* sk;
  float* cs_partial;  // (k_eff / 128, kdim) or null
  int kdim, m;
  int passes, pass_stride;  // rows of pass c: c pass_stride + 128 blockIdx.x
  int jt, kcp;  // column tiles; sketch-slice stride (0: no fused sketch)
};

template <typename T, int BN, bool SKETCH>
__global__ void __launch_bounds__(K1_THREADS, 1)
    matmul_sketch_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_b_lo,
                         K1Params<T> p) {
  using namespace hopper;
  constexpr int BK = Operand<T>::BK, PARTS = Operand<T>::PARTS;
  constexpr int G = Operand<T>::GROUPS, ROWS = SketchSlice<T>::ROWS;
  constexpr int A_BYTES = K1_BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = A_BYTES + PARTS * B_BYTES;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kcp = SKETCH ? p.kcp : 0;
  float* sk_acc = reinterpret_cast<float*>(smem + K1_STAGES * STAGE_BYTES);
  float* cs_acc = sk_acc + K1_BM * kcp;
  uint64_t* full = reinterpret_cast<uint64_t*>(cs_acc + 2 * G * kcp);
  uint64_t* empty = full + K1_STAGES;
  uint8_t* ring_b = smem + K1_STAGES * A_BYTES;

  const int tid = threadIdx.x;
  const int k_tiles = p.kdim / BK;
  const int col0 = blockIdx.y * BN;
  if (tid == 0) {
    for (int s = 0; s < K1_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K1_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= K1_CONSUMERS) {  // the producer warp; one thread issues
    if (tid == K1_CONSUMERS) {
      int st = 0;
      uint32_t ph = 0;
      for (int c = 0; c < p.passes; ++c) {
        const int r0 = c * p.pass_stride + blockIdx.x * K1_BM;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[st], ph ^ 1);
          mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
          uint8_t* b = ring_b + st * PARTS * B_BYTES;
          tma_load_2d(smem + st * A_BYTES, &map_a, &full[st], kt * BK, r0);
          tma_load_2d(b, &map_b, &full[st], kt * BK, col0);
          if (PARTS == 2)
            tma_load_2d(b + B_BYTES, &map_b_lo, &full[st], kt * BK, col0);
          if (++st == K1_STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // The sketch read (SketchSlice): this block's slice [c_lo, c_hi) of K;
  // the thread's column-sum row is G wg + lt / BK.
  const SketchSlice<T> xs(wg, lt, blockIdx.y, SKETCH ? p.jt : 1,
                          SKETCH ? p.kdim : 0);
  float acc[BN / 2];
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
        const int row = 64 * wg + 16 * warp + g + 8 * (e & 1);
        const int col = 8 * (ks0 + q) + t + 4 * (e >> 1);
        split_tf32(*reinterpret_cast<const float*>(
                       tile_a + swizzled_offset(row, col, 4)),
                   hi[q][e], lo[q][e]);
      }
  };
  // acc += A_hi B_hi + A_hi B_lo + A_lo B_hi over k steps ks0, ks0 + 1.
  auto mma_3xtf32 = [&](float (&d)[BN / 2], const uint32_t (&hi)[2][4],
                        const uint32_t (&lo)[2][4], uint32_t b_addr,
                        int ks0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint64_t bh = desc_sw128(b_addr + 32 * (ks0 + q));
      const uint64_t bl = desc_sw128(b_addr + B_BYTES + 32 * (ks0 + q));
      Wgmma<BN>::tf32_rs(d, hi[q], bh);
      Wgmma<BN>::tf32_rs(d, hi[q], bl);
      Wgmma<BN>::tf32_rs(d, lo[q], bh);
    }
  };
  int st = 0, prev = 0;
  uint32_t ph = 0;
  for (int c = 0; c < p.passes; ++c) {
    const int r0 = c * p.pass_stride + blockIdx.x * K1_BM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    float sig[ROWS];
    if (SKETCH) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) sig[i] = p.sigma[r0 + xs.row(i)];
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full[st], ph);
      __syncwarp();  // wgmma is .aligned: the warp converges first
      const uint8_t* tile_a = smem + st * A_BYTES;
      const uint32_t a_addr = smem_u32(tile_a) + 64 * wg * ROW_BYTES;
      const uint32_t b_addr = smem_u32(ring_b + st * PARTS * B_BYTES);
      if constexpr (PARTS == 2) load_split(tile_a, 0, hi0, lo0);
      fence_operands(acc);
      wgmma_fence();  // after the register writes the wgmma reads
      if constexpr (PARTS == 2) {
        mma_3xtf32(acc, hi0, lo0, b_addr, 0);
      } else {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<BN>::bf16_ss(acc, desc_sw128(a_addr + 32 * ks),
                             desc_sw128(b_addr + 32 * ks));
      }
      wgmma_commit();
      if (SKETCH) {  // while the tensor cores run
        if (xs.owns(kt)) {
          const float colsum = xs.add(tile_a, kt, sk_acc, kcp, c == 0,
                                      [&](int i) { return sig[i]; });
          float* cdst = cs_acc + (G * wg + lt / BK) * kcp + xs.col(kt);
          *cdst = c == 0 ? colsum : *cdst + colsum;
        }
        __syncwarp();
      }
      // One group stays in flight.  The one before it is done: the previous
      // tile's last, so its stage goes back to the producer (and for f32
      // the registers of its A fragments may be written again).
      wgmma_wait<1>();
      if constexpr (PARTS == 2) {
        keep_alive(hi1);
        keep_alive(lo1);
      }
      if (kt > 0) mbar_arrive(&empty[prev]);
      if constexpr (PARTS == 2) {  // the tile's second half, k 16..31
        load_split(tile_a, 2, hi1, lo1);
        wgmma_fence();
        mma_3xtf32(acc, hi1, lo1, b_addr, 2);
        wgmma_commit();
        wgmma_wait<1>();
        keep_alive(hi0);
        keep_alive(lo0);
      }
      prev = st;
      if (++st == K1_STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    if constexpr (PARTS == 2) {
      keep_alive(hi1);
      keep_alive(lo1);
    }
    fence_operands(acc);
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = col0 + 8 * i + 2 * t;
      const float b0 = p.bias != nullptr ? to_f(p.bias[col]) : 0.f;
      const float b1 = p.bias != nullptr ? to_f(p.bias[col + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 64 * wg + 16 * warp + g + 8 * h;
        store2(p.y + (size_t)row * p.m + col, acc[4 * i + 2 * h] + b0,
               acc[4 * i + 2 * h + 1] + b1);
      }
    }
  }
  if constexpr (SKETCH) {
    asm volatile("bar.sync 1, %0;" ::"n"(K1_CONSUMERS) : "memory");
    const int width = xs.c_hi - xs.c_lo;
    for (int e = tid; e < K1_BM * width; e += K1_CONSUMERS) {
      const int r = e / width, cc = e % width;
      p.sk[(size_t)(blockIdx.x * K1_BM + r) * p.kdim + xs.c_lo + cc] =
          from_f<T>(sk_acc[r * kcp + cc]);
    }
    if (p.cs_partial == nullptr) return;
    for (int cc = tid; cc < width; cc += K1_CONSUMERS) {
      float s = 0.f;
      for (int q = 0; q < 2 * G; ++q) s += cs_acc[q * kcp + cc];
      p.cs_partial[(size_t)blockIdx.x * p.kdim + xs.c_lo + cc] = s;
    }
  }
}

// Buckets per block of the separate sketch pass: K1_BM, so that its
// column-sum partials have the fused route's rows.
constexpr int SB = K1_BM;
constexpr int SC = 32;  // columns per block of the separate sketch pass

// The separate sketch pass, for the shapes whose sketch slice does not fit
// the GEMM's shared memory (of kernel 1, or of kernel 2').  Block (SC, 8) threads; blockIdx.x picks SC
// columns, blockIdx.y SB buckets; each thread owns (bucket, column) pairs
// and loops over the passes of its bucket.
template <typename T>
__global__ void input_sketch_kernel(const T* __restrict__ x,
                                    const float* __restrict__ sigma, int n,
                                    int kdim, int k_eff, T* __restrict__ sk,
                                    float* __restrict__ cs_partial) {
  __shared__ float red[8][SC];
  const int col = blockIdx.x * SC + threadIdx.x;
  const int passes = n / k_eff;
  float colsum = 0.f;
  if (col < kdim) {
    for (int i = 0; i < SB / 8; ++i) {
      const int b = blockIdx.y * SB + threadIdx.y + 8 * i;
      float acc = 0.f;
      for (int c = 0; c < passes; ++c) {
        const int r = c * k_eff + b;
        const float v = to_f(x[(size_t)r * kdim + col]);
        acc = fmaf(sigma[r], v, acc);
        colsum += v;
      }
      sk[(size_t)b * kdim + col] = from_f<T>(acc);
    }
  }
  if (cs_partial == nullptr) return;
  red[threadIdx.y][threadIdx.x] = colsum;
  __syncthreads();
  if (threadIdx.y == 0 && col < kdim) {
    float acc = 0.f;
    for (int t = 0; t < 8; ++t) acc += red[t][threadIdx.x];
    cs_partial[(size_t)blockIdx.y * kdim + col] = acc;
  }
}

template <typename T, int BN, bool SKETCH>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                const CUtensorMap& mb_lo, const K1Params<T>& p, int grid_x,
                int smem, cudaStream_t st) {
  auto kernel = matmul_sketch_kernel<T, BN, SKETCH>;
  // The whole limit, once per instantiation and device.
  static unsigned allowed = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;  // 0: every launch
  if (!(allowed & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K1_SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= bit;
  }
  kernel<<<dim3(grid_x, p.m / BN), K1_THREADS, smem, st>>>(ma, mb, mb_lo, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SKETCH>
int launch_gemm_bn(int bn, const CUtensorMap& ma, const CUtensorMap& mb,
                   const CUtensorMap& mb_lo, const K1Params<T>& p,
                   int grid_x, int smem, cudaStream_t st) {
  switch (bn) {
    case 64:
      return launch_gemm<T, 64, SKETCH>(ma, mb, mb_lo, p, grid_x, smem, st);
    case 96:
      return launch_gemm<T, 96, SKETCH>(ma, mb, mb_lo, p, grid_x, smem, st);
  }
  return -1;
}

// k1_smem of the element type's operand, or -1 where the tile width is not
// built or the block would exceed K1_SMEM_LIMIT.
template <typename T>
int gemm_smem(int kdim, int m, int bn, bool fused) {
  using Op = Operand<T>;
  if ((bn != 64 && bn != 96) || m % bn) return -1;
  const int jt = m / bn;
  const int smem =
      k1_smem(Op::PARTS, Op::GROUPS, bn, fused ? (kdim + jt - 1) / jt : 0);
  return smem > K1_SMEM_LIMIT ? -1 : smem;
}

template <typename T>
int launch(const void* x, const void* w, int w_trans, const void* bias,
           const float* sigma, void* y, void* sk, void* w_prep,
           float* cs_partial, float* cs, int n, int kdim, int m, int k_eff,
           int bn, bool fused, cudaStream_t st) {
  using Op = Operand<T>;
  const bool bf16 = sizeof(T) == 2;
  const int smem = gemm_smem<T>(kdim, m, bn, fused);
  if (smem < 0 || kdim % 128 || n % K1_BM || k_eff % K1_BM || n % k_eff)
    return -1;
  const int jt = m / bn;
  const int kcp = fused ? (kdim + jt - 1) / jt : 0;
  // B as the GEMM reads it: K-major, and split for f32; w itself for a
  // bf16 .t() weight, otherwise the prologue's output in w_prep.
  const bool prep = Op::PARTS == 2 || !w_trans;
  if (prep && w_prep == nullptr) return -1;
  T* hi = prep ? static_cast<T*>(w_prep) : nullptr;
  T* lo = Op::PARTS == 2 ? hi + (size_t)m * kdim : nullptr;
  const void* b_hi = prep ? static_cast<const void*>(hi) : w;
  const void* b_lo = lo != nullptr ? static_cast<const void*>(lo) : b_hi;
  CUtensorMap ma, mb, mb_lo;
  if (!hopper::make_tile_map(&ma, x, bf16, n, kdim, K1_BM) ||
      !hopper::make_tile_map(&mb, b_hi, bf16, m, kdim, bn) ||
      !hopper::make_tile_map(&mb_lo, b_lo, bf16, m, kdim, bn))
    return -2;
  if (prep)
    prep_weight_kernel<T><<<dim3(kdim / 32, m / 32), dim3(32, 8), 0, st>>>(
        static_cast<const T*>(w), w_trans, kdim, m, hi, lo);
  K1Params<T> p{static_cast<const T*>(bias),
                sigma,
                static_cast<T*>(y),
                static_cast<T*>(sk),
                fused ? cs_partial : nullptr,
                kdim,
                m,
                fused ? n / k_eff : 1,
                fused ? k_eff : 0,
                jt,
                kcp};
  const int grid_x = (fused ? k_eff : n) / K1_BM;
  if (!fused)
    return launch_gemm_bn<T, false>(bn, ma, mb, mb_lo, p, grid_x, smem, st);
  const int rc =
      launch_gemm_bn<T, true>(bn, ma, mb, mb_lo, p, grid_x, smem, st);
  if (rc != 0) return rc;
  if (cs_partial != nullptr)
    sum_partials_kernel<<<(kdim + 255) / 256, 256, 0, st>>>(
        cs_partial, k_eff / K1_BM, kdim, cs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_input_sketch(const void* x, const float* sigma, void* sk,
                        float* cs_partial, float* cs, int n, int kdim,
                        int k_eff, cudaStream_t st) {
  if (n <= 0 || kdim <= 0 || k_eff <= 0 || k_eff % SB || n % k_eff ||
      (cs_partial == nullptr) != (cs == nullptr))
    return -1;
  input_sketch_kernel<T><<<dim3((kdim + SC - 1) / SC, k_eff / SB),
                           dim3(SC, 8), 0, st>>>(
      static_cast<const T*>(x), sigma, n, kdim, k_eff, static_cast<T*>(sk),
      cs_partial);
  if (cs_partial != nullptr)
    sum_partials_kernel<<<(kdim + 255) / 256, 256, 0, st>>>(
        cs_partial, k_eff / SB, kdim, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit

// x (n, kdim), w the logical (kdim, m) weight (stored transposed when
// w_trans), bias (m,) or null, sigma (n,) f32, y (n, m), sk (k_eff, kdim);
// w_prep scratch for the K-major B: (2, m, kdim) for f32 (hi, lo), (m, kdim)
// for bf16 with w_trans = 0, null for bf16 with w_trans = 1; cs_partial
// (k_eff / 128, kdim) f32 and cs (kdim,) f32, both null when no column sum
// is wanted.  bn (96 or 64) and fused are the host's route
// (matmul_sketch_route).  Without fused, only y: sigma, sk, cs_partial and
// cs are unread, and the host launches the separate pass
// (fewbit_input_sketch) after it.  Returns cudaGetLastError() after the
// launches, -1 for arguments the kernels do not take (nothing launched), -2
// when the TMA descriptors cannot be encoded.
extern "C" int fewbit_matmul_input_sketch(
    const void* x, const void* w, int w_trans, const void* bias,
    const void* sigma, void* y, void* sk, void* w_prep, void* cs_partial,
    void* cs, int n, int kdim, int m, int k_eff, int bn, int fused,
    int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(sigma);
  float* cp = static_cast<float*>(cs_partial);
  float* c = static_cast<float*>(cs);
  if (is_bf16)
    return fewbit::launch<__nv_bfloat16>(x, w, w_trans, bias, sg, y, sk,
                                         w_prep, cp, c, n, kdim, m, k_eff,
                                         bn, fused != 0, st);
  return fewbit::launch<float>(x, w, w_trans, bias, sg, y, sk, w_prep, cp, c,
                               n, kdim, m, k_eff, bn, fused != 0, st);
}

// The separate sketch pass of kernels 1 and 2': sk (k_eff, kdim) of x
// (n, kdim) with sigma (n,) f32, and with cs_partial (k_eff / 128, kdim) f32
// and cs (kdim,) f32 the column sum of x (both null for none).  k_eff a
// multiple of 128 that divides n.  Returns cudaGetLastError() after the
// launches, -1 for arguments it does not take (nothing launched).
extern "C" int fewbit_input_sketch(const void* x, const void* sigma,
                                   void* sk, void* cs_partial, void* cs,
                                   int n, int kdim, int k_eff, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(sigma);
  float* cp = static_cast<float*>(cs_partial);
  float* c = static_cast<float*>(cs);
  if (is_bf16)
    return fewbit::launch_input_sketch<__nv_bfloat16>(x, sg, sk, cp, c, n,
                                                      kdim, k_eff, st);
  return fewbit::launch_input_sketch<float>(x, sg, sk, cp, c, n, kdim, k_eff,
                                            st);
}

// The dynamic shared memory that the GEMM block of this (kdim, m, bn,
// fused, dtype) takes, or -1 where the kernel refuses it (a width not
// built, or over the block's limit).  Launches nothing.
extern "C" int fewbit_matmul_sketch_smem(int kdim, int m, int bn, int fused,
                                         int is_bf16) {
  return is_bf16 ? fewbit::gemm_smem<__nv_bfloat16>(kdim, m, bn, fused != 0)
                 : fewbit::gemm_smem<float>(kdim, m, bn, fused != 0);
}
