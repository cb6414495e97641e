// What the four tensor-core schedules of the fused dense + activation +
// few-bit codes kernel share (dense_act.cu: the k loop; dense_act_direct.cu:
// the resident weight panel, with and without the pipelined output;
// dense_act_pipelined.cu: the ping-pong warpgroups): the arguments, the
// epilogue on a warpgroup's accumulator fragment, and the host's checks.
//
// The epilogue is kernel 2's (dense_act_sketch.cu) without its sketch: per
// element z = acc + b, y = act(z) stored as TO, and the code of z: the
// number of borders below it, four borders to a 16-byte read of the table
// and eight independent elements to a read (one block of 8 consumer warps
// on an SM makes the epilogue latency bound), or a piecewise function's
// predicate on the f32 z.  Each schedule is built twice: for GELU with
// border codes (ANY false: gelu_or_nan inline, the eight elements
// interleaved), and for any other spec (ANY: act_forward_any, one call per
// element, and the predicate); the host picks by the spec (da_any).  A
// packed word holds 32 consecutive rows of one column; a warp's fragment
// holds 16 (thread (g, t): rows g and g + 8, columns 8 i + 2 t + e), so
// each thread puts its rows' bits of a plane at bits g and g + 8 of a
// 16-bit half, two planes to a register, three xor-shuffles OR the halves
// over the 8 lanes that share a column, and the even and the odd warp of a
// 32-row group store the low and the high half of the word.
//
// Any N: TMA fills the rows of a tile past N with zeros; their y is not
// stored, their code bits are zero, and the last word row, ceil(N / 32) - 1,
// is written whole.
#pragma once

#include "ffn_gemm.cuh"

namespace fewbit {

template <typename TI, typename TO>
struct DaParams {
  const TI* bias;        // (m,) or null
  const float* borders;  // (n_borders,)
  TO* y;                 // (n, m)
  uint16_t* packed;      // (bits, words, m) 32-bit words, as their halves
  int n, kdim, m, words, bits, n_borders;
};

// Where the epilogue puts two neighbouring columns of y: device memory, rows
// past n masked ...
template <typename TO>
struct DaStoreGlobal {
  TO* y;
  int n, m;
  __device__ __forceinline__ void operator()(int row, int col, float a,
                                             float b) const {
    if (row < n) store2(y + (size_t)row * m + col, a, b);
  }
};

// ... or a dense (64, BN) tile in shared memory that a TMA store writes out
// (the store drops what lies past the tensor's edge).
template <typename TO, int BN>
struct DaStoreStage {
  TO* stage;
  int row0, col0;  // of the tile
  __device__ __forceinline__ void operator()(int row, int col, float a,
                                             float b) const {
    store2(stage + (row - row0) * BN + (col - col0), a, b);
  }
};

// GELU in the builds made for it (the host passes them no other id; NaN
// for one).  The id's check is there for nvcc's schedule: with gelu_exact
// called bare, the f32 k loop's build takes 121 registers where this takes
// 113, and runs 0.5-1% slower (PERF.md).
__device__ __forceinline__ float gelu_or_nan(int act, float z) {
  switch (act) {
    case ACT_GELU:
      return gelu_exact(z);
  }
  return __int_as_float(0x7fffffff);
}

// The epilogue of one warpgroup: acc is its fragment of the 64 x BN tile at
// (wg_row0, col0), (warp, g, t) the thread's place in the warpgroup, `table`
// the borders in shared memory padded with +inf to a multiple of four.
// Without EPILOGUE (the ablation that measures the epilogue's share): y = z
// and zero words in plane 0, the same stores without the arithmetic.  ANY:
// any activation and border or predicate codes; else GELU, borders.
template <typename TI, typename TO, int BN, bool EPILOGUE, bool ANY,
          typename StoreY>
__device__ __forceinline__ void da_epilogue(
    const float (&acc)[BN / 2], const DaParams<TI, TO>& p, const ActArgs& act,
    const float* table, int wg_row0, int col0, int warp, int g, int t,
    const StoreY& store_y) {
  const int row = wg_row0 + 16 * warp + g;  // and row + 8
  const bool valid[2] = {row < p.n, row + 8 < p.n};
  // The 32-row group of this warp: rows 32 (warp / 2) .. + 31 of the 64.
  const int word_row = (wg_row0 + 32 * (warp / 2)) / 32;
  const bool word_ok = word_row < p.words;
  const int word_half = warp & 1;  // the half of the words it writes
  const int border_quads = (p.n_borders + 3) / 4;
#pragma unroll
  for (int i0 = 0; i0 < BN / 8; i0 += 2) {
    float z[8];  // [u][h][e] of column groups i0 + u
    unsigned code[8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = col0 + 8 * (i0 + u) + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bj = p.bias != nullptr ? to_f(p.bias[col + e]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          z[4 * u + 2 * h + e] = acc[4 * (i0 + u) + 2 * h + e] + bj;
          code[4 * u + 2 * h + e] = 0u;
        }
      }
    }
    if constexpr (EPILOGUE) {
      for (int k = 0; k < border_quads; ++k) {
        const float4 bd = reinterpret_cast<const float4*>(table)[k];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          code[j] += (z[j] > bd.x ? 1u : 0u) + (z[j] > bd.y ? 1u : 0u) +
                     (z[j] > bd.z ? 1u : 0u) + (z[j] > bd.w ? 1u : 0u);
      }
      if constexpr (ANY) {
        if (act.kind == CODE_PREDICATE) {  // no borders
#pragma unroll
          for (int j = 0; j < 8; ++j) code[j] = predicate_code(act, z[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!valid[(j >> 1) & 1]) code[j] = 0u;  // a row past n: zero bits
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u, col = col0 + 8 * i + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z0 = z[4 * u + 2 * h], z1 = z[4 * u + 2 * h + 1];
        if constexpr (!EPILOGUE)
          store_y(row + 8 * h, col, z0, z1);
        else if constexpr (ANY)
          store_y(row + 8 * h, col,
                  act_forward_any(act.act, act.a0, act.a1, z0),
                  act_forward_any(act.act, act.a0, act.a1, z1));
        else
          store_y(row + 8 * h, col, gelu_or_nan(act.act, z0),
                  gelu_or_nan(act.act, z1));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // The codes of column col + e: row g in bits 0..7, row g + 8 in
        // bits 8..15.
        const uint32_t rows = code[4 * u + e] | (code[4 * u + 2 + e] << 8);
#pragma unroll
        for (int q = 0; q < 3; ++q) {  // planes 2 q and 2 q + 1
          if (2 * q < p.bits) {
            uint32_t v = 0u;
            if constexpr (EPILOGUE) {
              // Bit b of both rows' codes at bits g and g + 8 of b's half.
              v = (((rows >> (2 * q)) & 0x101u) << g) |
                  (((rows >> (2 * q + 1)) & 0x101u) << (g + 16));
              v |= __shfl_xor_sync(0xffffffffu, v, 4);
              v |= __shfl_xor_sync(0xffffffffu, v, 8);
              v |= __shfl_xor_sync(0xffffffffu, v, 16);
            }
            if (g == (i & 7) && word_ok) {
#pragma unroll
              for (int o = 0; o < 2; ++o) {
                const int b = 2 * q + o;
                if (b < p.bits)
                  p.packed[(((size_t)b * p.words + word_row) * p.m + col +
                            e) * 2 +
                           word_half] = static_cast<uint16_t>(v >> (16 * o));
              }
            }
          }
        }
      }
    }
  }
}

// The table, padded with +inf, into shared memory; the caller synchronises.
__device__ __forceinline__ void da_fill_table(
    float* table, const float* __restrict__ borders, int n_borders) {
  const int tid = threadIdx.x;
  if (tid < FG_TABLE)
    table[tid] = tid < n_borders ? borders[tid] : __int_as_float(0x7f800000);
}

// Host side: whether a spec takes the ANY build of a schedule (every spec
// but GELU with border codes).
inline bool da_any(const ActArgs& act) {
  return act.act != ACT_GELU || act.kind != CODE_BORDERS;
}

// Host side: the arguments every schedule refuses (-1, nothing launched).
inline bool da_args_ok(int n_borders, int bits, const ActArgs& act,
                       int epilogue) {
  return n_borders >= 0 && n_borders <= FG_TABLE && act_known(act, false) &&
         (epilogue ? bits >= 1 && bits <= 6 : bits == 1);
}

template <typename TI, typename TO>
DaParams<TI, TO> da_params(const void* bias, const void* borders,
                           int n_borders, void* y, void* packed, int n,
                           int kdim, int m, int bits) {
  return DaParams<TI, TO>{static_cast<const TI*>(bias),
                          static_cast<const float*>(borders),
                          static_cast<TO*>(y),
                          static_cast<uint16_t*>(packed),
                          n,
                          kdim,
                          m,
                          (n + 31) / 32,
                          bits,
                          n_borders};
}

// The SMs of the current device (persistent grids size themselves by it).
inline int da_sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Calls f(TI(), TO()) for the pair of element types the flags name: f32 ->
// f32 (three TF32 products), bf16 -> bf16, bf16 -> f32.  Returns -1 for f32
// -> bf16, which no caller asks for.
template <typename F>
int da_dispatch_types(int in_bf16, int out_bf16, F&& f) {
  if (!in_bf16) return out_bf16 ? -1 : f(float(), float());
  return out_bf16 ? f(__nv_bfloat16(), __nv_bfloat16())
                  : f(__nv_bfloat16(), float());
}

}  // namespace fewbit
