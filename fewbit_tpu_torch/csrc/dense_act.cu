// Fused dense + activation + few-bit codes: z = x @ w + b, y = act(z), and
// the interval code of z against the LUT's interior borders packed into bit
// planes.  No sketch: the caller keeps x itself, or sketches it apart.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_dense_act
// (_dense_act_kernel), the forward of the fused dense + few-bit activation
// (the GPT FFN's up projection).
//
// What bounds it on this card: at the GPT-2 small FFN up projection
// (8192 x 768 -> 3072) the product is 38.7 GFLOP against about 135 MB of
// f32 traffic, compute bound for any GEMM near the card's rate; this simple
// FMA core is bound by its own issue rate.  The epilogue adds one erff and
// 2^bits - 1 compares per element and writes y and bits / 8 bytes of codes;
// the (N, M) pre-activation never reaches device memory.
//
// Design: kernel 2 (dense_act_sketch.cu) without the sketch, so without its
// loop over the passes of the stride partition: one block per 128 x 128 tile
// of y.  Codes go through shared memory so that one warp holds 32
// consecutive rows of one column, and each bit plane is one __ballot_sync:
// word [b, w, m] holds bit b of the codes of rows 32 w .. 32 w + 31 of
// column m, the layout the backward (activation.cu) decodes.  Rows past N
// are masked: they read as zero, give zero bits and are not written.
#include "common.cuh"

namespace fewbit {
namespace {

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
    dense_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias,
                     const float* __restrict__ borders, int n_borders, int act,
                     int n, int kdim, int m, int bits, T* __restrict__ y,
                     uint32_t* __restrict__ packed) {
  __shared__ GemmSmem s;
  __shared__ unsigned char codes[BN][BM + PAD];
  __shared__ float bord[64];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16, lane = tid % 32, warp = tid / 32;
  if (tid < n_borders) bord[tid] = borders[tid];
  __syncthreads();

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int words = (n + 31) / 32;
  float acc[TM][TN];
  gemm_tile<T, TRANS_B>(x, w, n, kdim, m, row0, col0, s, acc);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col0 + tx + 16 * j;
    const float bj = (bias != nullptr && col < m) ? to_f(bias[col]) : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + 16 * i;
      unsigned code = 0;
      if (row < n && col < m) {
        const float z = acc[i][j] + bj;
        y[(size_t)row * m + col] = from_f<T>(act_forward(act, z));
        code = border_code(z, bord, n_borders);
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
}

template <typename T>
void launch(const void* x, const void* w, int w_trans, const void* bias,
            const float* borders, int n_borders, int act, void* y,
            uint32_t* packed, int n, int kdim, int m, int bits,
            cudaStream_t st) {
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  if (w_trans)
    dense_act_kernel<T, true><<<grid, NT, 0, st>>>(
        xt, wt, bt, borders, n_borders, act, n, kdim, m, bits,
        static_cast<T*>(y), packed);
  else
    dense_act_kernel<T, false><<<grid, NT, 0, st>>>(
        xt, wt, bt, borders, n_borders, act, n, kdim, m, bits,
        static_cast<T*>(y), packed);
}

}  // namespace
}  // namespace fewbit

// x (n, kdim), w the logical (kdim, m) weight (stored transposed when
// w_trans), bias (m,) or null, borders (n_borders,) f32 with n_borders < 64,
// act an activation id (common.cuh); outputs y (n, m) and packed
// (bits, ceil(n / 32), m) 32-bit words, bits in 1..6.  Any n (ragged rows
// are masked); ceil(n / 128) blocks must fit the grid's y extent
// (n <= 65535 * 128).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without launching for an unknown act, bits or row count.
extern "C" int fewbit_dense_act(const void* x, const void* w, int w_trans,
                                const void* bias, const void* borders,
                                int n_borders, int act, void* y, void* packed,
                                int n, int kdim, int m, int bits, int is_bf16,
                                void* stream) {
  using namespace fewbit;
  if (!act_known(act) || bits < 1 || bits > 6 || n_borders > 63 ||
      (n + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bd = static_cast<const float*>(borders);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, w_trans, bias, bd, n_borders, act, y, pk, n,
                          kdim, m, bits, st);
  else
    launch<float>(x, w, w_trans, bias, bd, n_borders, act, y, pk, n, kdim, m,
                  bits, st);
  return static_cast<int>(cudaGetLastError());
}
