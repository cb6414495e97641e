// Elementwise few-bit activation, forward and backward.
//
// Forward (kernel 4): y = act(x) for any activation id, the code of x
// (against the LUT's interior borders, a piecewise function's predicate, or
// stepwise's recentred count) packed into bit planes.  Replaces
// fewbit_tpu/ops/pallas_kernels.py: fused_forward (_forward_kernel).
// Backward (kernel 5): the codes decoded from the bit planes, dx =
// levels[code] * g in f32, stored in g's type.  Replaces fused_backward
// (_backward_kernel).
//
// What bounds them on this card: bytes.  At the RoBERTa FFN activation
// (8192 x 3072, f32) the forward reads x and writes y (201 MB) plus
// bits / 8 bytes of codes per element (9.4 MB at 3 bits), and the backward
// reads g and the codes and writes dx: about 60-65 us each at 3.35 TB/s.
// The arithmetic (one erff and 2^bits - 1 compares, or one shared-memory
// LUT read per element) is below the card's rate, if no loop of runtime
// length runs per element.
//
// Design: the packed layout (bits, ceil(R / 32), C) puts 32 consecutive rows
// of one column in a word.  A thread owns one word position (32 rows) of
// its columns, so the pack and unpack are shifts within the thread's
// registers: no shared memory, no ballot, no atomics.  The forward's thread
// owns 16 bytes of neighbouring columns (4 f32 or 8 bf16), read and written
// by one 16-byte access a row (a warp moves 512 bytes a row), and loads a
// group of rows before it computes any, so several rows are in flight.  Its
// code counts the borders below x from a table padded with +inf to 2^TB
// entries (TB, the table's bits, a template parameter), four borders to a
// read: no runtime-length loop per element.  It is built twice, chosen at
// launch by the spec (uniform over the launch): for GELU with border codes,
// gelu_exact inline; and for any other spec, the code of any kind
// (stepwise counts on x - s or |x - s| and adds its sign bit, a predicate
// is one compare pair) and act_forward_any called per element.  Its
// arguments come rounded to x's type (spec_args in ops/activations.py), so
// a bf16 x compares with bf16(lambda), as the JAX package's weakly typed
// scalars do; stepwise's shift stays f32, as its Pallas kernel recentres in
// f32.  A row or column past the edge is neither read nor written and
// gives zero bits; where C or an address does not allow 16-byte accesses,
// each element is read alone.  The backward's thread owns one column.  The TPU kernels aliased y onto x and
// dx onto g; these write fresh outputs.
#include "common.cuh"

namespace fewbit {
namespace {

constexpr int ACT_NT = 128;     // threads per block
constexpr int MAX_BITS = 6;     // the wrappers' envelope
constexpr int MAX_GRID_Y = 65535;

// Kernel 4's thread: V columns of one type, 16 bytes; ROWS rows loaded
// before any is computed.
template <typename T> struct ActVec;
template <> struct ActVec<float> {
  static constexpr int V = 4, ROWS = 8;
  static __device__ __forceinline__ void load(float (&v)[4], const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct ActVec<__nv_bfloat16> {
  static constexpr int V = 8, ROWS = 4;
  static __device__ __forceinline__ void load(float (&v)[8],
                                              const __nv_bfloat16* p) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Kernel 4.  TB: the bits of the padded table (at least `bits`, and
// 2^TB - 1 >= n_borders); VEC: 16-byte accesses (C a multiple of V, x, y
// and packed 16-byte aligned), else one element at a time.  ANY false: GELU
// with border codes, four borders to a read for all V columns, gelu_exact
// inline; ANY: any activation and code kind (act), act_forward_any per
// element.
template <typename T, int TB, bool VEC, bool ANY>
__global__ void __launch_bounds__(ACT_NT)
    act_forward_kernel(const T* __restrict__ x,
                       const float* __restrict__ borders, int n_borders,
                       ActArgs act, int r, int c, int bits,
                       T* __restrict__ y, uint32_t* __restrict__ packed) {
  using A = ActVec<T>;
  constexpr int V = A::V, ROWS = A::ROWS;
  constexpr int NQ = ((1 << TB) + 3) / 4;  // float4s of the table
  __shared__ float4 table[NQ];
  for (int i = threadIdx.x; i < 4 * NQ; i += ACT_NT)
    reinterpret_cast<float*>(table)[i] =
        i < n_borders ? borders[i] : __int_as_float(0x7f800000);
  __syncthreads();
  const int col0 = (blockIdx.x * ACT_NT + threadIdx.x) * V;
  if (col0 >= c) return;
  const int words = (r + 31) / 32;
  for (int w = blockIdx.y; w < words; w += gridDim.y) {
    const int row0 = w * 32;
    uint32_t word[TB][V];
#pragma unroll
    for (int b = 0; b < TB; ++b)
#pragma unroll
      for (int j = 0; j < V; ++j) word[b][j] = 0u;
#pragma unroll 1
    for (int i0 = 0; i0 < 32; i0 += ROWS) {
      float v[ROWS][V];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int row = row0 + i0 + u;
        const size_t at = (size_t)row * c + col0;
#pragma unroll
        for (int j = 0; j < V; ++j) v[u][j] = 0.f;
        if (row < r) {
          if constexpr (VEC) {
            A::load(v[u], x + at);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (col0 + j < c) v[u][j] = to_f(x[at + j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int row = row0 + i0 + u;
        if (row >= r) break;
        unsigned code[V];
        float out[V];
        if constexpr (ANY) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            // Stepwise recentres (and folds) x; the other kinds have
            // shift 0 and parity -1, and a predicate no borders.
            const float zs = v[u][j] - act.shift;
            const float b = act.parity >= 0 ? fabsf(zs) : zs;
            code[j] = 0u;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const float4 bd = table[q];
              code[j] += (b > bd.x ? 1u : 0u) + (b > bd.y ? 1u : 0u) +
                         (b > bd.z ? 1u : 0u) + (b > bd.w ? 1u : 0u);
            }
            if (act.parity == 1 && zs < 0.f) code[j] += 1u << (bits - 1);
            if (act.kind == CODE_PREDICATE)
              code[j] = predicate_code(act, v[u][j]);
            out[j] = act_forward_any(act.act, act.a0, act.a1, v[u][j]);
#pragma unroll
            for (int b = 0; b < TB; ++b)
              word[b][j] |= ((code[j] >> b) & 1u) << (i0 + u);
          }
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) code[j] = 0u;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 bd = table[q];
#pragma unroll
            for (int j = 0; j < V; ++j)
              code[j] += (v[u][j] > bd.x ? 1u : 0u) +
                         (v[u][j] > bd.y ? 1u : 0u) +
                         (v[u][j] > bd.z ? 1u : 0u) +
                         (v[u][j] > bd.w ? 1u : 0u);
          }
#pragma unroll
          for (int j = 0; j < V; ++j) {
            out[j] = gelu_exact(v[u][j]);
#pragma unroll
            for (int b = 0; b < TB; ++b)
              word[b][j] |= ((code[j] >> b) & 1u) << (i0 + u);
          }
        }
        const size_t at = (size_t)row * c + col0;
        if constexpr (VEC) {
          A::store(y + at, out);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (col0 + j < c) y[at + j] = from_f<T>(out[j]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (b >= bits) break;
      uint32_t* dst = packed + ((size_t)b * words + w) * c + col0;
      if constexpr (VEC) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<uint4*>(dst + j) = make_uint4(
              word[b][j], word[b][j + 1], word[b][j + 2], word[b][j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (col0 + j < c) dst[j] = word[b][j];
      }
    }
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

template <typename T, int TB>
void launch_forward(bool vec, dim3 grid, cudaStream_t st, const void* x,
                    const float* bd, int n_borders, const ActArgs& act, int r,
                    int c, int bits, void* y, uint32_t* pk) {
  // The GELU build for GELU with border codes, the ANY build otherwise;
  // the spec is uniform over the launch.
  const bool any = act.act != ACT_GELU || act.kind != CODE_BORDERS;
  auto kernel = any ? (vec ? act_forward_kernel<T, TB, true, true>
                           : act_forward_kernel<T, TB, false, true>)
                    : (vec ? act_forward_kernel<T, TB, true, false>
                           : act_forward_kernel<T, TB, false, false>);
  kernel<<<grid, ACT_NT, 0, st>>>(static_cast<const T*>(x), bd, n_borders,
                                  act, r, c, bits, static_cast<T*>(y), pk);
}

template <typename T>
void launch_forward(int tb, cudaStream_t st, const void* x, const float* bd,
                    int n_borders, const ActArgs& act, int r, int c, int bits,
                    void* y, uint32_t* pk) {
  constexpr int V = ActVec<T>::V;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = c % V == 0 && aligned(x) && aligned(y) && aligned(pk);
  const int words = (r + 31) / 32;
  const dim3 grid(((c + V - 1) / V + ACT_NT - 1) / ACT_NT,
                  words < MAX_GRID_Y ? words : MAX_GRID_Y);
  switch (tb) {
    case 1:
      return launch_forward<T, 1>(vec, grid, st, x, bd, n_borders, act, r, c,
                                  bits, y, pk);
    case 2:
      return launch_forward<T, 2>(vec, grid, st, x, bd, n_borders, act, r, c,
                                  bits, y, pk);
    case 3:
      return launch_forward<T, 3>(vec, grid, st, x, bd, n_borders, act, r, c,
                                  bits, y, pk);
    case 4:
      return launch_forward<T, 4>(vec, grid, st, x, bd, n_borders, act, r, c,
                                  bits, y, pk);
    case 5:
      return launch_forward<T, 5>(vec, grid, st, x, bd, n_borders, act, r, c,
                                  bits, y, pk);
    default:
      return launch_forward<T, 6>(vec, grid, st, x, bd, n_borders, act, r, c,
                                  bits, y, pk);
  }
}

}  // namespace
}  // namespace fewbit

// x (r, c), borders (n_borders,) f32 with n_borders < 64, act_args the
// host address of an ActArgs (common.cuh; any kind, its arguments in x's
// type); outputs y (r, c) and packed (bits, ceil(r / 32), c) 32-bit words,
// bits in 1..6; any r and c.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue without launching for an unknown activation,
// code kind or bits.
extern "C" int fewbit_act_forward(const void* x, const void* borders,
                                  int n_borders, const void* act_args,
                                  void* y, void* packed, int r, int c,
                                  int bits, int is_bf16, void* stream) {
  using namespace fewbit;
  const ActArgs act = *static_cast<const ActArgs*>(act_args);
  if (!act_known(act, true) || bits < 1 || bits > MAX_BITS ||
      n_borders < 0 || n_borders > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r <= 0 || c <= 0) return 0;
  int tb = bits;  // the padded table holds every border
  while ((1 << tb) - 1 < n_borders) ++tb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bd = static_cast<const float*>(borders);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  if (is_bf16)
    launch_forward<__nv_bfloat16>(tb, st, x, bd, n_borders, act, r, c, bits,
                                  y, pk);
  else
    launch_forward<float>(tb, st, x, bd, n_borders, act, r, c, bits, y, pk);
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
