// Fused matmul + LUT dequant + countsketch + bias gradient: acc = g @ wt,
// dz = levels[code] * acc with the codes decoded from the packed bit
// planes, sk_dz[b] = sum_{r = b mod k_eff} sigma_r dz_r and db = sum_r dz_r
// in f32.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_matmul_lut_backward
// (_matmul_lut_bwd_kernel), the backward of the few-bit FFN block.
//
// What bounds it on this card: at the FFN shapes (8192 x 768 @ 768 x 3072)
// the product is 38.7 GFLOP against about 130 MB of f32 traffic plus
// bits / 8 bytes of codes per element, compute bound for any GEMM near the
// card's rate; this simple FMA core is bound by its own issue rate.  The
// epilogue is a handful of integer ops and one shared-memory LUT read per
// element; the (N, M) product acc never reaches device memory.
//
// Design: the TPU kernel accumulated the sketch and db across sequential
// grid steps.  Here a block owns one tile of BM buckets and BN columns and
// loops over the N / k_eff passes itself (the stride partition puts rows
// c k_eff + bucket0 + [0, BM) of every pass into the same buckets), so the
// sketch tile is summed in registers and written once.  db is a per-block
// partial, reduced in a fixed order in shared memory, then summed over the
// blocks by sum_partials_kernel.  No atomics: deterministic.
#include "common.cuh"

namespace fewbit {
namespace {

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
    matmul_lut_bwd_kernel(const T* __restrict__ g, const T* __restrict__ wt,
                          const uint32_t* __restrict__ packed,
                          const float* __restrict__ levels, int bits,
                          const float* __restrict__ sigma, int n, int h,
                          int m, int k_eff, T* __restrict__ dz,
                          T* __restrict__ sk,
                          float* __restrict__ db_partial) {
  __shared__ GemmSmem s;
  __shared__ float lv[64];
  __shared__ float red[NT / 16][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  if (tid < (1 << bits)) lv[tid] = levels[tid];
  __syncthreads();

  const int bucket0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int passes = n / k_eff, words = (n + 31) / 32;
  float ska[TM][TN], dba[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    dba[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) ska[i][j] = 0.f;
  }

  for (int c = 0; c < passes; ++c) {
    const int row0 = c * k_eff + bucket0;
    float acc[TM][TN];
    gemm_tile<T, TRANS_B>(g, wt, n, h, m, row0, col0, s, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= n) continue;
      const float sg = sigma[row];
      const int word_row = row / 32, bit = row % 32;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col >= m) continue;
        unsigned code = 0;
        for (int b = 0; b < bits; ++b)
          code |= ((packed[((size_t)b * words + word_row) * m + col] >> bit) &
                   1u) << b;
        const float d = lv[code] * acc[i][j];
        const T dt = from_f<T>(d);
        dz[(size_t)row * m + col] = dt;
        // The sketch sums dz as stored; db sums the f32 value.
        ska[i][j] = fmaf(sg, to_f(dt), ska[i][j]);
        dba[j] += d;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int bucket = bucket0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < m) sk[(size_t)bucket * m + col] = from_f<T>(ska[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + 16 * j] = dba[j];
  __syncthreads();
  if (tid < BN) {
    const int col = col0 + tid;
    float acc = 0.f;
    for (int t = 0; t < NT / 16; ++t) acc += red[t][tid];
    if (col < m) db_partial[(size_t)blockIdx.y * m + col] = acc;
  }
}

template <typename T>
void launch(const void* g, const void* wt, int w_trans, const uint32_t* packed,
            const float* levels, int bits, const float* sigma, void* dz,
            void* sk, float* db_partial, float* db, int n, int h, int m,
            int k_eff, cudaStream_t st) {
  dim3 grid((m + BN - 1) / BN, k_eff / BM);
  const T* gt = static_cast<const T*>(g);
  const T* wtt = static_cast<const T*>(wt);
  if (w_trans)
    matmul_lut_bwd_kernel<T, true><<<grid, NT, 0, st>>>(
        gt, wtt, packed, levels, bits, sigma, n, h, m, k_eff,
        static_cast<T*>(dz), static_cast<T*>(sk), db_partial);
  else
    matmul_lut_bwd_kernel<T, false><<<grid, NT, 0, st>>>(
        gt, wtt, packed, levels, bits, sigma, n, h, m, k_eff,
        static_cast<T*>(dz), static_cast<T*>(sk), db_partial);
  sum_partials_kernel<<<(m + 255) / 256, 256, 0, st>>>(db_partial, k_eff / BM,
                                                       m, db);
}

}  // namespace
}  // namespace fewbit

// g (n, h), wt the logical (h, m) operand (stored transposed when w_trans),
// packed (bits, ceil(n / 32), m) 32-bit words, levels (2^bits,) f32,
// sigma (n,) f32; outputs dz (n, m), sk (k_eff, m), db (m,) f32, with
// db_partial (k_eff / 128, m) f32 scratch.  k_eff must be a multiple of 128
// that divides n, and bits at most 6.  Returns cudaGetLastError().
extern "C" int fewbit_matmul_lut_backward(const void* g, const void* wt,
                                          int w_trans, const void* packed,
                                          const void* levels, int bits,
                                          const void* sigma, void* dz,
                                          void* sk, void* db_partial, void* db,
                                          int n, int h, int m, int k_eff,
                                          int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  const float* lv = static_cast<const float*>(levels);
  const float* sg = static_cast<const float*>(sigma);
  float* dp = static_cast<float*>(db_partial);
  float* d = static_cast<float*>(db);
  if (is_bf16)
    fewbit::launch<__nv_bfloat16>(g, wt, w_trans, pk, lv, bits, sg, dz, sk,
                                  dp, d, n, h, m, k_eff, st);
  else
    fewbit::launch<float>(g, wt, w_trans, pk, lv, bits, sg, dz, sk, dp, d, n,
                          h, m, k_eff, st);
  return static_cast<int>(cudaGetLastError());
}
