// Shared pieces of the few-bit Hopper kernels: the element types, the
// activations and interval codes, a tiled shared-memory GEMM core with f32
// accumulators, and the deterministic column-partial reduction.
//
// The GEMM core (gemm_tile) computes one BM x BN tile of A @ B with FMA on
// CUDA cores: 256 threads, each holding an 8 x 8 block of f32 accumulators
// at rows ty + 16 i and columns tx + 16 j of the tile (strided, so that the
// shared-memory reads of one warp are conflict free or broadcast).
// Operands of either element type are widened to f32 on their way into
// shared memory, so a bf16 model multiplies bf16 values with f32
// accumulation.  It is the simple, correct core of kernel 6 and of kernel
// 2's sigma_x mode.  Kernels 1, 2 and 3 run on the tensor cores instead
// (TMA ring and wgmma: hopper_gemm.cuh, ffn_gemm.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fewbit {

constexpr int BM = 128;   // rows of a tile
constexpr int BN = 128;   // columns of a tile
constexpr int BK = 8;     // reduction depth per shared-memory stage
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // shared-memory row padding against bank conflicts
constexpr int TM = 8;     // accumulator rows per thread
constexpr int TN = 8;     // accumulator columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// The value a T store keeps, back in f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Activation ids, in the order of ACT_IDS in fewbit_tpu_torch/ops/
// activations.py: GELU, the other continuous functions, the piecewise ones,
// and the identity forward of the generic stepwise.
enum ActId {
  ACT_GELU = 0,
  ACT_CELU,
  ACT_ELU,
  ACT_HARDSWISH,
  ACT_LOGSIGMOID,
  ACT_MISH,
  ACT_SELU,
  ACT_SIGMOID,
  ACT_SILU,
  ACT_SOFTPLUS,
  ACT_SOFTSIGN,
  ACT_TANH,
  ACT_TANHSHRINK,
  ACT_HARDSHRINK,
  ACT_HARDSIGMOID,
  ACT_HARDTANH,
  ACT_LEAKY_RELU,
  ACT_RELU,
  ACT_RELU6,
  ACT_SOFTSHRINK,
  ACT_THRESHOLD,
  ACT_IDENTITY,
  ACT_COUNT
};

// How a code is computed (CODE_KINDS in ops/activations.py): the number of
// borders below z; a piecewise function's 1-bit predicate; stepwise's count
// on z - s or |z - s|, with a sign bit for an odd derivative.
enum CodeKind { CODE_BORDERS = 0, CODE_PREDICATE = 1, CODE_STEPWISE = 2 };

// What a kernel reads of an activation spec, passed by value (kernel_args
// in ops/activations.py fills it; ActArgs in ops/kernels.py is its ctypes
// twin).  The entry points take it by host address.
struct ActArgs {
  int act;       // ActId of the forward
  int kind;      // CodeKind
  float a0, a1;  // the forward's arguments (lambda, alpha, slope, min/max,
                 // beta/threshold, threshold/value), 0 where unused
  float lo, hi;  // predicate: lo < b and not b >= hi (hi NaN: no upper
                 // bound), b = |z| when pred_abs, else z
  int pred_abs;
  float shift;   // stepwise: s
  int parity;    // stepwise: -1 (None), 0 (False), 1 (True)
};

// Host side: the arguments no kernel takes.  Kernels 6 and 2 compute no
// stepwise codes (no activation name resolves to stepwise).
inline bool act_known(const ActArgs& a, bool stepwise) {
  return a.act >= 0 && a.act < ACT_COUNT && a.kind >= CODE_BORDERS &&
         a.kind <= (stepwise ? CODE_STEPWISE : CODE_PREDICATE) &&
         a.parity >= -1 && a.parity <= 1;
}

__device__ __forceinline__ float gelu_exact(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// log(1 + e^t) in its stable form.
__device__ __forceinline__ float softplus_stable(float t) {
  return fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)));
}

__device__ __forceinline__ float sigmoid_exact(float z) {
  return 1.f / (1.f + expf(-z));
}

// z clamped to [lo, hi], NaN passed through (as jnp.clip).
__device__ __forceinline__ float clip(float z, float lo, float hi) {
  return z < lo ? lo : (z > hi ? hi : z);
}

// act(z) for any id, on the exact libm forms, as the plain versions in
// fewbit_tpu_torch/functional/activations.py compute them.  Not inlined:
// one copy serves every call site, called element by element.  The kernels
// that run GELU with border codes on a training path are built apart for
// it (gelu_exact inline, independent elements interleaved), so that this
// switch and its call cost GELU nothing; the host picks the build by the
// spec, which is uniform over the launch.
static __device__ __noinline__ float act_forward_any(int act, float a0,
                                                     float a1, float z) {
  switch (act) {
    case ACT_GELU:
      return gelu_exact(z);
    case ACT_CELU:
      return z > 0.f ? z : a0 * expm1f(z / a0);
    case ACT_ELU:
      return z > 0.f ? z : a0 * expm1f(z);
    case ACT_HARDSWISH:
      return z * clip(z + 3.f, 0.f, 6.f) / 6.f;
    case ACT_LOGSIGMOID:
      return -softplus_stable(-z);
    case ACT_MISH:
      return z * tanhf(softplus_stable(z));
    case ACT_SELU:
      return 1.0507009873554805f *
             (z > 0.f ? z : 1.6732632423543772f * expm1f(z));
    case ACT_SIGMOID:
      return sigmoid_exact(z);
    case ACT_SILU:
      return z * sigmoid_exact(z);
    case ACT_SOFTPLUS: {
      const float scaled = z * a0;
      return scaled > a1 ? z : softplus_stable(scaled) / a0;
    }
    case ACT_SOFTSIGN:
      return z / (1.f + fabsf(z));
    case ACT_TANH:
      return tanhf(z);
    case ACT_TANHSHRINK:
      return z - tanhf(z);
    case ACT_HARDSHRINK:
      return fabsf(z) > a0 ? z : 0.f;
    case ACT_HARDSIGMOID:
      return clip(z / 6.f + 0.5f, 0.f, 1.f);
    case ACT_HARDTANH:
      return clip(z, a0, a1);
    case ACT_LEAKY_RELU:
      return z >= 0.f ? z : z * a0;
    case ACT_RELU:
      return z < 0.f ? 0.f : z;
    case ACT_RELU6:
      return clip(z, 0.f, 6.f);
    case ACT_SOFTSHRINK:
      return z > a0 ? z - a0 : (z < -a0 ? z + a0 : 0.f);
    case ACT_THRESHOLD:
      return z > a0 ? z : a1;
    case ACT_IDENTITY:
      return z;
  }
  return __int_as_float(0x7fffffff);  // NaN: an id the host refuses
}

// A piecewise function's 1-bit code of z (CODE_PREDICATE).
__device__ __forceinline__ unsigned predicate_code(const ActArgs& a,
                                                   float z) {
  const float b = a.pred_abs ? fabsf(z) : z;
  return (b > a.lo && !(b >= a.hi)) ? 1u : 0u;
}

// The interval code of z: the number of borders strictly below it, compared
// in f32, as compare_codes in fewbit_tpu_torch/ops/activations.py.
__device__ __forceinline__ unsigned border_code(float z, const float* bord,
                                                int n_borders) {
  unsigned code = 0;
  for (int k = 0; k < n_borders; ++k) code += z > bord[k] ? 1u : 0u;
  return code;
}

// The code of z, element by element (the CUDA-core kernels 6 and 2',
// which compute no stepwise codes): the borders below z, or a predicate's
// bit.
__device__ __forceinline__ unsigned any_code(const ActArgs& a, float z,
                                             const float* bord,
                                             int n_borders) {
  return a.kind == CODE_PREDICATE ? predicate_code(a, z)
                                  : border_code(z, bord, n_borders);
}

struct GemmSmem {
  float a[BK][BM + PAD];
  float b[BK][BN + PAD];
};

// acc[i][j] = sum_k A[row0 + ty + 16 i, k] * B[k, col0 + tx + 16 j].
// A is row-major (n, kdim).  B is the logical (kdim, m) operand: row-major
// when TRANS_B is false, and stored as its row-major (m, kdim) transpose
// when TRANS_B is true (a torch weight of shape (out, in)).  Every edge is
// masked: rows >= n, columns >= m and depth >= kdim read as zero.
//
// With skx, the read of A also feeds a signed row sum: skx[bucket0 + r, k]
// = (first ? 0 : skx[bucket0 + r, k]) + sigx[row0 + r] A[row0 + r, k], in
// f32, each element read and written by the one thread that loads it (the
// countsketch of A over passes of a stride partition, kernel 2's sigma_x
// mode).
template <typename T, bool TRANS_B>
__device__ __forceinline__ void gemm_tile(
    const T* __restrict__ A, const T* __restrict__ B, int n, int kdim, int m,
    int row0, int col0, GemmSmem& s, float acc[TM][TN],
    float* __restrict__ skx = nullptr, const float* __restrict__ sigx = nullptr,
    int bucket0 = 0, bool first = false) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + NT * q;
      const int r = e / BK, ka = e % BK;
      const int gr = row0 + r, gka = k0 + ka;
      const bool in_a = gr < n && gka < kdim;
      const float av = in_a ? to_f(A[(size_t)gr * kdim + gka]) : 0.f;
      s.a[ka][r] = av;
      if (skx != nullptr && in_a) {
        float* dst = skx + (size_t)(bucket0 + r) * kdim + gka;
        const float add = sigx[gr] * av;
        *dst = first ? add : *dst + add;
      }
      int c, kb;
      if (TRANS_B) {
        c = e / BK;
        kb = e % BK;
      } else {
        kb = e / BN;
        c = e % BN;
      }
      const int gc = col0 + c, gkb = k0 + kb;
      float v = 0.f;
      if (gc < m && gkb < kdim)
        v = to_f(TRANS_B ? B[(size_t)gc * kdim + gkb] : B[(size_t)gkb * m + gc]);
      s.b[kb][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[c] = sum_{t < parts} partial[t, c], summed in order t = 0, 1, ...:
// the second, deterministic pass of every cross-block column sum.
static __global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int parts, int m, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= m) return;
  float acc = 0.f;
  for (int t = 0; t < parts; ++t) acc += partial[(size_t)t * m + c];
  out[c] = acc;
}

}  // namespace fewbit
