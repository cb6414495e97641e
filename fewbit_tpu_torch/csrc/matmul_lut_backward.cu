// Fused matmul + LUT dequant + countsketch + bias gradient: acc = g @ wt,
// dz = levels[code] * acc with the codes decoded from the packed bit
// planes, sk_dz[b] = sum_{r = b mod k_eff} sigma_r dz_r and db = sum_r dz_r
// in f32.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_matmul_lut_backward
// (_matmul_lut_bwd_kernel), the backward of the few-bit FFN block.
//
// What bounds it on this card: at the FFN shapes (8192 x 768 @ 768 x 3072)
// the product is 38.7 GFLOP against 170 MB of f32 traffic (g 25, wt 9,
// codes 9, dz 101, sketch 25; 90 MB in bf16).  The tensor cores bound it:
// 0.039 ms in bf16 at 989 TFLOP/s, 0.234 ms in f32 as three TF32 products
// at 495 TFLOP/s, against 0.027-0.051 ms for the bytes at 3.35 TB/s.  The
// epilogue is a handful of integer ops and one shared-memory LUT read per
// element, not overlapped with the block's own wgmma; the (N, M) product
// acc never reaches device memory.
//
// Design: the mainloop of ffn_gemm.cuh (TMA ring, two consumer warpgroups
// on wgmma, 128 buckets x BN columns per block, the block loops over the
// N / k_eff passes).  wt is the down projection's (H, M) row-major
// parameter in the model, MN-major for this product; wgmma reads B K-major,
// so the prologue (prep_weight_kernel) transposes it, and splits it for
// f32, into scratch.  Per pass, on the accumulator fragment:
// - the codes of the thread's two rows (g and g + 8 of its warp's 16) and
//   two neighbouring columns come from one 8-byte load per bit plane: the
//   32-row word of both columns, the same address for the 8 lanes that
//   share the columns (a broadcast);
// - dz = levels[code] * acc stored as T two columns at a time, and
//   sk += sigma_row * (dz as stored) in the thread's own f32 accumulators
//   (shared memory, ffn_gemm.cuh), stored once, by the last pass;
// - db from the f32 value: the two rows of a thread, then three
//   xor-shuffles over the 8 lanes that share a column, then one shared
//   memory row per warp summed over the passes by its owning lane; after
//   the last pass the 8 warps' rows are added in order into one partial row
//   per 128 buckets, and sum_partials_kernel adds the partial rows in order.
// No atomics: bitwise repeatable.
// Registers per thread (nvcc 12.8, -Xptxas -v; the cap of a 288-thread
// block is 168): f32 127 (BN 96) and 112 (BN 64), bf16 112 and 96; no
// spills.  On an H100 SXM at 700 W the path shape takes about 0.45 ms in
// f32 (51% of the bound) and 0.22 ms in bf16 (18%), a fifth to a third of
// it the epilogue (the code words' loads included).
#include "ffn_gemm.cuh"

namespace fewbit {
namespace {

template <typename T>
struct K3Params {
  const uint32_t* packed;  // (bits, words, m)
  const float* levels;     // (2^bits,)
  const float* sigma;      // (n,)
  T* dz;                   // (n, m)
  T* sk;                   // (k_eff, m)
  float* db_partial;       // (k_eff / 128, m)
  int h, m, words, bits;
  int passes, pass_stride;  // rows of pass c: c pass_stride + 128 blockIdx.x
};

template <typename T, int BN>
__global__ void __launch_bounds__(FG_THREADS, 1)
    matmul_lut_bwd_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ CUtensorMap map_b_lo,
                          K3Params<T> p) {
  extern __shared__ uint8_t smem_raw[];
  const FgSmem<T, BN> s(smem_raw);
  fg_init(s, p.levels, 1 << p.bits, 0.f);
  const int bucket0 = blockIdx.x * FG_BM, col0 = blockIdx.y * BN;
  const int k_tiles = p.h / Operand<T>::BK;
  if (threadIdx.x >= FG_CONSUMERS) {  // the producer warp; one thread loads
    if (threadIdx.x == FG_CONSUMERS)
      fg_produce(s, &map_a, &map_b, &map_b_lo, p.passes, p.pass_stride,
                 bucket0, col0, k_tiles);
    return;
  }
  const FgThread th;
  float* ska = s.ska + threadIdx.x;  // element idx at ska[idx * FG_CONSUMERS]
  float* red = s.red + (threadIdx.x / 32) * BN;  // this warp's db row
  // The thread's rows g and g + 8 of its warp's 16 are bits bit0 and
  // bit0 + 8 of the packed word of its 32-row group.
  const int bit0 = 16 * (th.warp & 1) + th.g;
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < p.passes; ++c) {
    const int r0 = c * p.pass_stride + bucket0;
    const bool first = c == 0, last = c == p.passes - 1;
    float acc[BN / 2];
    fg_consume_pass<T, BN>(acc, s, th, k_tiles, st, ph);
    float sg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sg[h] = p.sigma[r0 + th.row + 8 * h];
    const size_t word_row = (r0 + 64 * th.wg + 32 * (th.warp / 2)) / 32;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * th.t, col = col0 + cl;
      unsigned code[2][2] = {{0u, 0u}, {0u, 0u}};  // [h][e]
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        if (b < p.bits) {
          const uint2 wd = *reinterpret_cast<const uint2*>(
              p.packed + ((size_t)b * p.words + word_row) * p.m + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            code[h][0] |= ((wd.x >> (bit0 + 8 * h)) & 1u) << b;
            code[h][1] |= ((wd.y >> (bit0 + 8 * h)) & 1u) << b;
          }
        }
      }
      float dbv[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dv[2], skv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * h + e;
          const float d = s.table[code[h][e]] * acc[idx];
          dbv[e] += d;  // db sums the f32 value
          // The sketch sums dz as stored, widened to f32.
          dv[e] = round_to<T>(d);
          skv[e] = fmaf(sg[h], dv[e], first ? 0.f : ska[idx * FG_CONSUMERS]);
          if (!last) ska[idx * FG_CONSUMERS] = skv[e];
        }
        store2(p.dz + (size_t)(r0 + th.row + 8 * h) * p.m + col, dv[0],
               dv[1]);
        if (last)
          store2(p.sk + (size_t)(bucket0 + th.row + 8 * h) * p.m + col,
                 skv[0], skv[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dbv[e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (th.g == (i & 7)) red[cl + e] = first ? v : red[cl + e] + v;
      }
    }
  }
  fg_consumer_sync();
  if (threadIdx.x < BN) {
    float sum = 0.f;
    for (int w = 0; w < FG_CONSUMERS / 32; ++w)
      sum += s.red[w * BN + threadIdx.x];
    p.db_partial[(size_t)blockIdx.x * p.m + col0 + threadIdx.x] = sum;
  }
}

template <typename T, int BN>
int launch_bn(const CUtensorMap& ma, const CUtensorMap& mb,
              const CUtensorMap& mb_lo, const K3Params<T>& p, int k_eff,
              cudaStream_t st) {
  auto kernel = matmul_lut_bwd_kernel<T, BN>;
  static unsigned allowed = 0;
  const int err =
      fg_allow_smem(reinterpret_cast<const void*>(kernel), allowed);
  if (err != 0) return err;
  kernel<<<dim3(k_eff / FG_BM, p.m / BN), FG_THREADS,
           fg_smem(Operand<T>::PARTS, BN), st>>>(ma, mb, mb_lo, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const void* wt, int w_trans, const uint32_t* packed,
           const float* levels, int bits, const float* sigma, void* dz,
           void* sk, float* db_partial, float* db, void* w_prep, int n, int h,
           int m, int k_eff, int bn, cudaStream_t st) {
  if (bits < 1 || bits > 6) return -1;
  CUtensorMap ma, mb, mb_lo;
  int rc = fg_operands<T>(g, wt, w_trans, w_prep, n, h, m, k_eff, bn, &ma, &mb,
                          &mb_lo, st);
  if (rc != 0) return rc;
  K3Params<T> p{packed,
                levels,
                sigma,
                static_cast<T*>(dz),
                static_cast<T*>(sk),
                db_partial,
                h,
                m,
                (n + 31) / 32,
                bits,
                n / k_eff,
                k_eff};
  rc = bn == 96 ? launch_bn<T, 96>(ma, mb, mb_lo, p, k_eff, st)
                : launch_bn<T, 64>(ma, mb, mb_lo, p, k_eff, st);
  if (rc != 0) return rc;
  sum_partials_kernel<<<(m + 255) / 256, 256, 0, st>>>(db_partial,
                                                       k_eff / FG_BM, m, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit

// g (n, h), wt the logical (h, m) operand (stored transposed when w_trans),
// packed (bits, ceil(n / 32), m) 32-bit words, levels (2^bits,) f32,
// sigma (n,) f32; outputs dz (n, m), sk (k_eff, m), db (m,) f32, with
// db_partial (k_eff / 128, m) f32 scratch and w_prep scratch for the K-major
// B: (2, m, h) for f32 (hi, lo), (m, h) for bf16 with w_trans = 0, null for
// bf16 with w_trans = 1.  k_eff must be a multiple of 128 that divides n, h
// a multiple of 128, m of bn (the host's tile width, ffn_gemm_route: 96 or
// 64), bits at most 6, g and a bf16 transposed wt 16-byte aligned.  Returns
// cudaGetLastError() after the launches, -1 for arguments the kernels do
// not take (nothing launched), -2 when the TMA descriptors cannot be
// encoded.
extern "C" int fewbit_matmul_lut_backward(
    const void* g, const void* wt, int w_trans, const void* packed,
    const void* levels, int bits, const void* sigma, void* dz, void* sk,
    void* db_partial, void* db, void* w_prep, int n, int h, int m, int k_eff,
    int bn, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  const float* lv = static_cast<const float*>(levels);
  const float* sg = static_cast<const float*>(sigma);
  float* dp = static_cast<float*>(db_partial);
  float* d = static_cast<float*>(db);
  if (is_bf16)
    return fewbit::launch<__nv_bfloat16>(g, wt, w_trans, pk, lv, bits, sg, dz,
                                         sk, dp, d, w_prep, n, h, m, k_eff, bn,
                                         st);
  return fewbit::launch<float>(g, wt, w_trans, pk, lv, bits, sg, dz, sk, dp, d,
                               w_prep, n, h, m, k_eff, bn, st);
}
