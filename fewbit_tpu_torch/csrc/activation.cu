// Elementwise few-bit activation, forward and backward.
//
// Forward: y = act(x), the interval code of x against the LUT's interior
// borders, packed into bit planes.  Replaces
// fewbit_tpu/ops/pallas_kernels.py: fused_forward (_forward_kernel).
// Backward: the codes decoded from the bit planes, dx = levels[code] * g in
// f32, stored in g's type.  Replaces fused_backward (_backward_kernel).
//
// What bounds them on this card: bytes.  At the RoBERTa FFN activation
// (8192 x 3072, f32) the forward reads x and writes y (201 MB) plus
// bits / 8 bytes of codes per element (9.4 MB at 3 bits), and the backward
// reads g and the codes and writes dx: about 60-65 us each at 3.35 TB/s.
// The arithmetic (one erff and 2^bits - 1 compares, or one shared-memory
// LUT read per element) is far below the card's rate.
//
// Design: the packed layout (bits, ceil(R / 32), C) puts 32 consecutive rows
// of one column in a word.  A thread owns one word position (32 rows of one
// column) and walks its rows, so neighbouring threads of a warp touch
// neighbouring columns (coalesced reads and writes of x, y, g and dx), and
// the pack and unpack are shifts within the thread's registers: no shared
// memory, no ballot, no atomics.  Rows past R give zero bits and are neither
// read nor written.  The TPU kernels aliased y onto x and dx onto g; these
// write fresh outputs.
#include "common.cuh"

namespace fewbit {
namespace {

constexpr int ACT_NT = 128;     // threads per block, one column each
constexpr int MAX_BITS = 6;     // the wrappers' envelope
constexpr int MAX_GRID_Y = 65535;

template <typename T>
__global__ void __launch_bounds__(ACT_NT)
    act_forward_kernel(const T* __restrict__ x,
                       const float* __restrict__ borders, int n_borders,
                       int act, int r, int c, int bits, T* __restrict__ y,
                       uint32_t* __restrict__ packed) {
  __shared__ float bord[64];
  const int tid = threadIdx.x;
  if (tid < n_borders) bord[tid] = borders[tid];
  __syncthreads();
  const int col = blockIdx.x * ACT_NT + tid;
  if (col >= c) return;
  const int words = (r + 31) / 32;
  for (int w = blockIdx.y; w < words; w += gridDim.y) {
    const int row0 = w * 32, rows = min(32, r - row0);
    uint32_t word[MAX_BITS];
#pragma unroll
    for (int b = 0; b < MAX_BITS; ++b) word[b] = 0u;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const size_t idx = (size_t)(row0 + i) * c + col;
      const float v = to_f(x[idx]);
      y[idx] = from_f<T>(act_forward(act, v));
      const unsigned code = border_code(v, bord, n_borders);
#pragma unroll
      for (int b = 0; b < MAX_BITS; ++b)
        word[b] |= ((code >> b) & 1u) << i;
    }
#pragma unroll
    for (int b = 0; b < MAX_BITS; ++b)
      if (b < bits) packed[((size_t)b * words + w) * c + col] = word[b];
  }
}

template <typename T>
__global__ void __launch_bounds__(ACT_NT)
    act_backward_kernel(const uint32_t* __restrict__ packed,
                        const float* __restrict__ levels, int bits,
                        const T* __restrict__ g, int r, int c,
                        T* __restrict__ dx) {
  __shared__ float lv[64];
  const int tid = threadIdx.x;
  if (tid < (1 << bits)) lv[tid] = levels[tid];
  __syncthreads();
  const int col = blockIdx.x * ACT_NT + tid;
  if (col >= c) return;
  const int words = (r + 31) / 32;
  for (int w = blockIdx.y; w < words; w += gridDim.y) {
    const int row0 = w * 32, rows = min(32, r - row0);
    uint32_t word[MAX_BITS];
#pragma unroll
    for (int b = 0; b < MAX_BITS; ++b)
      word[b] = b < bits ? packed[((size_t)b * words + w) * c + col] : 0u;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      unsigned code = 0;
#pragma unroll
      for (int b = 0; b < MAX_BITS; ++b) code |= ((word[b] >> i) & 1u) << b;
      const size_t idx = (size_t)(row0 + i) * c + col;
      dx[idx] = from_f<T>(lv[code] * to_f(g[idx]));
    }
  }
}

dim3 act_grid(int r, int c) {
  const int words = (r + 31) / 32;
  return dim3((c + ACT_NT - 1) / ACT_NT, words < MAX_GRID_Y ? words
                                                            : MAX_GRID_Y);
}

}  // namespace
}  // namespace fewbit

// x (r, c), borders (n_borders,) f32 with n_borders < 64, act an activation
// id (common.cuh); outputs y (r, c) and packed (bits, ceil(r / 32), c)
// 32-bit words, bits in 1..6.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue without launching for an unknown act or bits.
extern "C" int fewbit_act_forward(const void* x, const void* borders,
                                  int n_borders, int act, void* y,
                                  void* packed, int r, int c, int bits,
                                  int is_bf16, void* stream) {
  using namespace fewbit;
  if (!act_known(act) || bits < 1 || bits > MAX_BITS || n_borders > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bd = static_cast<const float*>(borders);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  const dim3 grid = act_grid(r, c);
  if (is_bf16)
    act_forward_kernel<__nv_bfloat16><<<grid, ACT_NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), bd, n_borders, act, r, c, bits,
        static_cast<__nv_bfloat16*>(y), pk);
  else
    act_forward_kernel<float><<<grid, ACT_NT, 0, st>>>(
        static_cast<const float*>(x), bd, n_borders, act, r, c, bits,
        static_cast<float*>(y), pk);
  return static_cast<int>(cudaGetLastError());
}

// packed (bits, ceil(r / 32), c) 32-bit words, levels (2^bits,) f32, g
// (r, c); output dx (r, c) in g's type.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue without launching for bits outside
// 1..6.
extern "C" int fewbit_act_backward(const void* packed, const void* levels,
                                   int bits, const void* g, void* dx, int r,
                                   int c, int is_bf16, void* stream) {
  using namespace fewbit;
  if (bits < 1 || bits > MAX_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  const float* lv = static_cast<const float*>(levels);
  const dim3 grid = act_grid(r, c);
  if (is_bf16)
    act_backward_kernel<__nv_bfloat16><<<grid, ACT_NT, 0, st>>>(
        pk, lv, bits, static_cast<const __nv_bfloat16*>(g), r, c,
        static_cast<__nv_bfloat16*>(dx));
  else
    act_backward_kernel<float><<<grid, ACT_NT, 0, st>>>(
        pk, lv, bits, static_cast<const float*>(g), r, c,
        static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}
