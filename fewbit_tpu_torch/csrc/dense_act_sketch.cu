// Fused dense + GELU + few-bit codes + output countsketch: z = x @ w + b,
// y = gelu(z), the interval code of z against the LUT's interior borders
// packed into bit planes, and sk_y[b] = sum_{r = b mod k_eff} sigma_r y_r.
// With sigma_x (kernel 2'), also the input countsketch
// sk_x[b] = sum_{r = b mod k_eff} sigma_x,r x_r, from the kernel's own read
// of x.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_dense_act_sketch
// (_dense_act_sketch_kernel through _kernel_no_skx, and through _kernel_skx
// with sigma_x), the forward of the few-bit FFN block.
//
// What bounds it on this card: at the FFN up projection (8192 x 768 ->
// 3072) the product is 38.7 GFLOP against about 135 MB of f32 traffic,
// compute bound for any GEMM near the card's rate; this simple FMA core is
// bound by its own issue rate.  The epilogue adds one erff and 2^bits - 1
// compares per element and writes y, bits / 8 bytes of codes and the
// (k_eff, M) sketch; the (N, M) pre-activation never reaches device memory.
//
// Design: the TPU kernel accumulated the sketch across sequential grid
// steps.  Here a block owns one tile of BM buckets and BN columns and loops
// over the N / k_eff passes itself: with the stride partition, rows
// c k_eff + bucket0 + [0, BM) of every pass c land in the same BM buckets,
// so the sketch tile is summed in registers (f32) and written once.  No
// atomics, deterministic.  sk_x follows the same ownership: only the blocks
// of the first column tile sum it (the TPU kernel summed it at column block
// j == 0), each thread adding sigma_x x for the elements of x it loads into
// shared memory to an f32 accumulator it alone reads and writes, pass after
// pass; a bf16 model's sketch is converted by the same thread at the end.
// The accumulator costs (k_eff, K) f32 read and written once per pass from
// those blocks.  Codes go through shared memory so that one warp
// holds 32 consecutive rows of one column, and each bit plane is one
// __ballot_sync: word [b, w, m] holds bit b of the codes of rows
// 32 w .. 32 w + 31 of column m.  GELU is the exact erff form.
#include "common.cuh"

namespace fewbit {
namespace {

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
    dense_act_sketch_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ bias,
                            const float* __restrict__ borders, int n_borders,
                            const float* __restrict__ sigma, int n, int kdim,
                            int m, int k_eff, int bits, T* __restrict__ y,
                            uint32_t* __restrict__ packed,
                            T* __restrict__ sk,
                            const float* __restrict__ sigma_x,
                            float* __restrict__ skx_acc,
                            T* __restrict__ skx_out) {
  __shared__ GemmSmem s;
  __shared__ unsigned char codes[BN][BM + PAD];
  __shared__ float bord[64];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16, lane = tid % 32, warp = tid / 32;
  if (tid < n_borders) bord[tid] = borders[tid];
  __syncthreads();

  const int bucket0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int passes = n / k_eff, words = (n + 31) / 32;
  float bj[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col0 + tx + 16 * j;
    bj[j] = (bias != nullptr && col < m) ? to_f(bias[col]) : 0.f;
  }
  float ska[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) ska[i][j] = 0.f;

  float* skx = (skx_acc != nullptr && blockIdx.x == 0) ? skx_acc : nullptr;
  for (int c = 0; c < passes; ++c) {
    const int row0 = c * k_eff + bucket0;
    float acc[TM][TN];
    gemm_tile<T, TRANS_B>(x, w, n, kdim, m, row0, col0, s, acc, skx,
                          sigma_x, bucket0, c == 0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + 16 * i;
      const float sg = row < n ? sigma[row] : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx + 16 * j;
        unsigned code = 0;
        if (row < n && col < m) {
          const float z = acc[i][j] + bj[j];
          const T yt = from_f<T>(gelu_exact(z));
          y[(size_t)row * m + col] = yt;
          code = border_code(z, bord, n_borders);
          // The sketch sums y as stored, widened to f32.
          ska[i][j] = fmaf(sg, to_f(yt), ska[i][j]);
        }
        codes[tx + 16 * j][ty + 16 * i] = static_cast<unsigned char>(code);
      }
    }
    __syncthreads();
    for (int p = warp; p < (BM / 32) * BN; p += NT / 32) {
      const int wr = p / BN, cl = p % BN;
      const unsigned code = codes[cl][wr * 32 + lane];
      const int col = col0 + cl, word_row = row0 / 32 + wr;
      for (int b = 0; b < bits; ++b) {
        const unsigned word = __ballot_sync(0xffffffffu, (code >> b) & 1u);
        if (lane == b && col < m && word_row < words)
          packed[((size_t)b * words + word_row) * m + col] = word;
      }
    }
    __syncthreads();
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
  // The f32 accumulator into the sketch dtype, element by element by the
  // thread that summed it (gemm_tile's load mapping).
  if (skx != nullptr && skx_out != nullptr) {
    for (int k0 = 0; k0 < kdim; k0 += BK)
#pragma unroll
      for (int q = 0; q < (BM * BK) / NT; ++q) {
        const int e = tid + NT * q, gk = k0 + e % BK;
        const size_t at = (size_t)(bucket0 + e / BK) * kdim + gk;
        if (gk < kdim) skx_out[at] = from_f<T>(skx[at]);
      }
  }
}

template <typename T>
void launch(const void* x, const void* w, int w_trans, const void* bias,
            const float* borders, int n_borders, const float* sigma, void* y,
            uint32_t* packed, void* sk, const float* sigma_x,
            float* skx_acc, void* skx_out, int n, int kdim, int m, int k_eff,
            int bits, cudaStream_t st) {
  dim3 grid((m + BN - 1) / BN, k_eff / BM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  if (w_trans)
    dense_act_sketch_kernel<T, true><<<grid, NT, 0, st>>>(
        xt, wt, bt, borders, n_borders, sigma, n, kdim, m, k_eff, bits,
        static_cast<T*>(y), packed, static_cast<T*>(sk), sigma_x, skx_acc,
        static_cast<T*>(skx_out));
  else
    dense_act_sketch_kernel<T, false><<<grid, NT, 0, st>>>(
        xt, wt, bt, borders, n_borders, sigma, n, kdim, m, k_eff, bits,
        static_cast<T*>(y), packed, static_cast<T*>(sk), sigma_x, skx_acc,
        static_cast<T*>(skx_out));
}

}  // namespace
}  // namespace fewbit

// x (n, kdim), w the logical (kdim, m) weight (stored transposed when
// w_trans), bias (m,) or null, borders (n_borders,) f32 with n_borders < 64,
// sigma (n,) f32; outputs y (n, m), packed (bits, ceil(n / 32), m) 32-bit
// words and sk (k_eff, m).  With sigma_x (n,) f32 (else null), also sk_x
// (k_eff, kdim): summed in skx_acc (k_eff, kdim) f32, which is the result
// when skx_out is null (f32 models) and is converted into skx_out otherwise
// (bf16).  k_eff must be a multiple of 128 that divides n, and bits at most
// 6.  Returns cudaGetLastError() after the launch.
extern "C" int fewbit_dense_act_sketch(const void* x, const void* w,
                                       int w_trans, const void* bias,
                                       const void* borders, int n_borders,
                                       const void* sigma, void* y,
                                       void* packed, void* sk,
                                       const void* sigma_x, void* skx_acc,
                                       void* skx_out, int n, int kdim, int m,
                                       int k_eff, int bits, int is_bf16,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bd = static_cast<const float*>(borders);
  const float* sg = static_cast<const float*>(sigma);
  const float* sgx = static_cast<const float*>(sigma_x);
  float* acc = static_cast<float*>(skx_acc);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  if (is_bf16)
    fewbit::launch<__nv_bfloat16>(x, w, w_trans, bias, bd, n_borders, sg, y,
                                  pk, sk, sgx, acc, skx_out, n, kdim, m,
                                  k_eff, bits, st);
  else
    fewbit::launch<float>(x, w, w_trans, bias, bd, n_borders, sg, y, pk, sk,
                          sgx, acc, skx_out, n, kdim, m, k_eff, bits, st);
  return static_cast<int>(cudaGetLastError());
}
