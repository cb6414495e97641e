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
// 768 -> 768) the product is 2 N K M = 9.7 GFLOP against about 38 MB of
// f32 operands and outputs, so it is compute bound on any GEMM that reaches
// a fair share of the card's rate; this simple FMA core does not, and is
// bound by its own issue rate.  The sketch reads x once more (N K elements)
// and writes k_eff K, a memory-bound pass.
//
// Design: the TPU kernel carried the sketch slab and the column sum from one
// sequential grid step to the next.  GPU blocks run in no order, so the
// sketch is a second launch of this file, in which each thread owns a
// (bucket, column) pair and loops over the N / k_eff rows of its bucket:
// every sketch element is written once, with no atomics, and is
// deterministic.  The column sum is per-block partials plus an ordered sum
// (sum_partials_kernel).  Fusing the sketch into the GEMM's own read of x is
// later work.
#include "common.cuh"

namespace fewbit {
namespace {

constexpr int SB = 64;  // buckets per block of the sketch pass
constexpr int SC = 32;  // columns per block of the sketch pass

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
    matmul_bias_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, int n, int kdim, int m,
                       T* __restrict__ y) {
  __shared__ GemmSmem s;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
  gemm_tile<T, TRANS_B>(x, w, n, kdim, m, row0, col0, s, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float bj[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col0 + tx + 16 * j;
    bj[j] = (bias != nullptr && col < m) ? to_f(bias[col]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < m) y[(size_t)row * m + col] = from_f<T>(acc[i][j] + bj[j]);
    }
  }
}

// Block (SC, 8) threads; blockIdx.x picks SC columns, blockIdx.y SB buckets.
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

template <typename T>
void launch(const void* x, const void* w, int w_trans, const void* bias,
            const float* sigma, void* y, void* sk, float* cs_partial,
            float* cs, int n, int kdim, int m, int k_eff, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  if (w_trans)
    matmul_bias_kernel<T, true><<<grid, NT, 0, st>>>(xt, wt, bt, n, kdim, m,
                                                     static_cast<T*>(y));
  else
    matmul_bias_kernel<T, false><<<grid, NT, 0, st>>>(xt, wt, bt, n, kdim, m,
                                                      static_cast<T*>(y));
  dim3 sgrid((kdim + SC - 1) / SC, k_eff / SB);
  input_sketch_kernel<T><<<sgrid, dim3(SC, 8), 0, st>>>(
      xt, sigma, n, kdim, k_eff, static_cast<T*>(sk), cs_partial);
  if (cs_partial != nullptr)
    sum_partials_kernel<<<(kdim + 255) / 256, 256, 0, st>>>(
        cs_partial, k_eff / SB, kdim, cs);
}

}  // namespace
}  // namespace fewbit

// x (n, kdim), w the logical (kdim, m) weight (stored transposed when
// w_trans), bias (m,) or null, sigma (n,) f32, y (n, m), sk (k_eff, kdim);
// cs_partial (k_eff / 64, kdim) f32 scratch and cs (kdim,) f32, both null
// when no column sum is wanted.  k_eff must be a multiple of 64 that
// divides n.  Returns cudaGetLastError() after the launches.
extern "C" int fewbit_matmul_input_sketch(const void* x, const void* w,
                                          int w_trans, const void* bias,
                                          const void* sigma, void* y, void* sk,
                                          void* cs_partial, void* cs, int n,
                                          int kdim, int m, int k_eff,
                                          int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(sigma);
  float* cp = static_cast<float*>(cs_partial);
  float* c = static_cast<float*>(cs);
  if (is_bf16)
    fewbit::launch<__nv_bfloat16>(x, w, w_trans, bias, sg, y, sk, cp, c, n,
                                  kdim, m, k_eff, st);
  else
    fewbit::launch<float>(x, w, w_trans, bias, sg, y, sk, cp, c, n, kdim, m,
                          k_eff, st);
  return static_cast<int>(cudaGetLastError());
}
