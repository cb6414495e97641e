// Flash attention for head dimension 64 on CUDA cores: the first forward
// (F1) and dK/dV and dQ backward kernels, which the tensor-core ones of
// flash_forward.cu and flash_backward.cu replaced on every path (entry
// points ..._forward_simt, ..._dkv_simt and ..._dq_simt: kept to be
// measured against).
//
// Replaces JAX's Pallas TPU library kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which the JAX models
// call for flash_attention: the forward pallas_call (_flash_attention_impl),
// the dK/dV one (_flash_attention_bwd_dkv) and the dQ one
// (_flash_attention_bwd_dq).  Semantics of the library: S = sm_scale * Q K^T
// (scaled after the product), DEFAULT_MASK_VALUE (-0.7 FLT_MAX, finite) added
// where the causal or segment mask is false, P = softmax(S), O = P V; the
// backward takes di = sum(dO * O) per row (computed by the caller) and
// dS = P (dO V^T - di) sm_scale, dQ = dS K, dK = dS^T Q, dV = P^T dO.
//
// What bounds it on this card: at GPT-2 small (8 x 12 heads, seq 1024) the
// forward is 2 * 2 * 96 * 1024^2 * 64 = 25.8 GFLOP (half of it under the
// causal mask) against 75 MB of q, k, v and o in f32: compute bound.  These
// simple cores multiply on CUDA cores with FMA.  What they save is memory:
// the (s, s) probabilities never reach device memory, only one f32
// log-sum-exp per row.
//
// Design: the TPU grid walked kv blocks sequentially and carried m, l and the
// accumulator in scratch between grid steps.  Here one block of 256 threads
// owns a 64-row tile and loops over the other side's 64-row tiles itself:
// forward and dQ a query tile (looping over kv tiles), dK/dV a kv tile
// (looping over query tiles).  Nothing is summed across blocks, so there are
// no atomics and both gradients are deterministic.  Each thread holds a 4 x 4
// block of a tile at rows ty + 16 i and columns tx + 16 j; a row's max and
// sum of the online softmax are reduced over the 16 lanes that share ty.
// Tiles of q, k, v and dO are widened to f32 in shared memory, rows padded
// to 65 floats against bank conflicts.  Under the causal mask a query tile
// stops at the diagonal kv tile and a kv tile starts at the diagonal query
// tile, as the library skips blocks above the diagonal.  Keys past the
// sequence are left out of the softmax (probability exactly 0); query rows
// past it are computed on zeros and not stored.  Operands of any (b, h, s)
// strides with unit stride along d are read in place, so the model's
// (b, s, h, d) projections need no transposed copy.
#include <math.h>

#include "flash_params.cuh"

namespace fewbit {
namespace {

constexpr int FD = 64;      // head dimension
constexpr int FB = 64;      // rows of a query tile and of a kv tile
constexpr int FNT = 256;    // threads per block
constexpr int FP = FD + 1;  // padded shared-memory row, in floats
constexpr int TILE = FB * FP;

template <typename T>
__device__ __forceinline__ const T* slice(const void* p, const Strides& st,
                                          int bi, int hi) {
  return static_cast<const T*>(p) + bi * st.b + hi * st.h;
}

template <typename T>
__device__ __forceinline__ T* slice_out(void* p, const Strides& st, int bi,
                                        int hi) {
  return static_cast<T*>(p) + bi * st.b + hi * st.h;
}

// tile[r][d] = base[row0 + r, d] widened to f32, rows >= nrows as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  for (int e = threadIdx.x; e < FB * FD; e += FNT) {
    const int r = e / FD, d = e % FD, gr = row0 + r;
    tile[r * FP + d] =
        gr < nrows ? to_f(base[(long long)gr * row_stride + d]) : 0.f;
  }
}

// ids[r] = seg[bi, row0 + r] of a (batch, nrows) array (0 past nrows);
// nothing without segment ids.
__device__ __forceinline__ void load_ids(int* ids, const int* seg, int bi,
                                         int row0, int nrows) {
  if (seg != nullptr && threadIdx.x < FB)
    ids[threadIdx.x] = row0 + threadIdx.x < nrows
                           ? seg[(long long)bi * nrows + row0 + threadIdx.x]
                           : 0;
}

// vals[r] = src[row0 + r] (0 past nrows).
__device__ __forceinline__ void load_rows(float* vals, const float* src,
                                          int row0, int nrows) {
  if (threadIdx.x < FB)
    vals[threadIdx.x] =
        row0 + threadIdx.x < nrows ? src[row0 + threadIdx.x] : 0.f;
}

// The scaled logit of query row r and key column c with the mask added.
__device__ __forceinline__ float masked_logit(const FlashParams& p, float s,
                                              int r, int c, int id_q,
                                              int id_kv) {
  float val = s * p.scale;
  bool keep = p.seg_q == nullptr || id_q == id_kv;
  if (p.causal) keep = keep && c <= r;
  return keep ? val : val + MASK_VALUE;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kv tiles a query tile at q0 visits: all, or up to the diagonal.
__device__ __forceinline__ int kv_tiles(const FlashParams& p, int q0) {
  int n = (p.sk + FB - 1) / FB;
  if (p.causal) n = min(n, (min(q0 + FB, p.sq) - 1) / FB + 1);
  return n;
}

template <typename T>
__global__ void __launch_bounds__(FNT)
    flash_forward_simt_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float *qs = smem, *ks = qs + TILE, *vs = ks + TILE, *ps = vs + TILE;
  __shared__ int ids_q[FB], ids_kv[FB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * FB, bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const T* k = slice<T>(p.k, p.st_k, bi, hi);
  const T* v = slice<T>(p.v, p.st_v, bi, hi);
  load_tile(qs, slice<T>(p.q, p.st_q, bi, hi), p.st_q.s, q0, p.sq);
  load_ids(ids_q, p.seg_q, bi, q0, p.sq);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int n_tiles = kv_tiles(p, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FB;
    __syncthreads();
    load_tile(ks, k, p.st_k.s, k0, p.sk);
    load_tile(vs, v, p.st_v.s, k0, p.sk);
    load_ids(ids_kv, p.seg_kv, bi, k0, p.sk);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < FD; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * FP + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * FP + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        // A key past the sequence takes no part: exp(-inf - m) = 0.
        s[i][j] = c < p.sk ? masked_logit(p, s[i][j], r, c,
                                          ids_q[ty + 16 * i],
                                          ids_kv[tx + 16 * j])
                           : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // Every tile holds a key below sk, so m_new is finite.
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * FP + tx + 16 * j] = pv;
        rs += pv;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FB; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * FP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = vs[kk * FP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  T* o = slice_out<T>(p.o, p.st_o, bi, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[(long long)r * p.st_o.s + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (tx == 0) p.lse_out[(long long)bh * p.sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(FNT)
    flash_backward_dkv_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float *ks = smem, *vs = ks + TILE, *qs = vs + TILE, *dos = qs + TILE;
  float *ps = dos + TILE, *dss = ps + TILE;
  __shared__ int ids_q[FB], ids_kv[FB];
  __shared__ float lse_s[FB], di_s[FB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * FB, bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const T* q = slice<T>(p.q, p.st_q, bi, hi);
  const T* dout = slice<T>(p.dout, p.st_do, bi, hi);
  load_tile(ks, slice<T>(p.k, p.st_k, bi, hi), p.st_k.s, k0, p.sk);
  load_tile(vs, slice<T>(p.v, p.st_v, bi, hi), p.st_v.s, k0, p.sk);
  load_ids(ids_kv, p.seg_kv, bi, k0, p.sk);

  // Rows c = k0 + ty + 16 i, columns d = tx + 16 j.
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int n_tiles = (p.sq + FB - 1) / FB;
  // Under the causal mask query tiles above the diagonal see none of these
  // keys (the forward skipped them too).
  for (int t = p.causal ? k0 / FB : 0; t < n_tiles; ++t) {
    const int q0 = t * FB;
    __syncthreads();
    load_tile(qs, q, p.st_q.s, q0, p.sq);
    load_tile(dos, dout, p.st_do.s, q0, p.sq);
    load_ids(ids_q, p.seg_q, bi, q0, p.sq);
    load_rows(lse_s, p.lse_in + (long long)bh * p.sq, q0, p.sq);
    load_rows(di_s, p.di + (long long)bh * p.sq, q0, p.sq);
    __syncthreads();
    // S^T and dP^T: rows are keys, columns queries r = q0 + tx + 16 j.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < FD; ++dd) {
      float a[4], a2[4], b[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty + 16 * i) * FP + dd];
        a2[i] = vs[(ty + 16 * i) * FP + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qs[(tx + 16 * j) * FP + dd];
        b2[j] = dos[(tx + 16 * j) * FP + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(a2[i], b2[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + tx + 16 * j, rl = tx + 16 * j;
        float pt = 0.f, dst = 0.f;
        if (r < p.sq && c < p.sk) {
          const float val = masked_logit(p, st[i][j], r, c, ids_q[rl],
                                         ids_kv[ty + 16 * i]);
          pt = expf(val - lse_s[rl]);
          dst = pt * (dpt[i][j] - di_s[rl]) * p.scale;
        }
        ps[(ty + 16 * i) * FP + rl] = pt;
        dss[(ty + 16 * i) * FP + rl] = dst;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FB; ++kk) {
      float a[4], a2[4], b[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ps[(ty + 16 * i) * FP + kk];
        a2[i] = dss[(ty + 16 * i) * FP + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = dos[kk * FP + tx + 16 * j];
        b2[j] = qs[kk * FP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv[i][j] = fmaf(a[i], b[j], dv[i][j]);
          dk[i][j] = fmaf(a2[i], b2[j], dk[i][j]);
        }
    }
  }
  T* dk_out = slice_out<T>(p.dk, p.st_dk, bi, hi);
  T* dv_out = slice_out<T>(p.dv, p.st_dv, bi, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk_out[(long long)c * p.st_dk.s + tx + 16 * j] = from_f<T>(dk[i][j]);
      dv_out[(long long)c * p.st_dv.s + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FNT)
    flash_backward_dq_kernel(FlashParams p) {
  extern __shared__ float smem[];
  float *qs = smem, *dos = qs + TILE, *ks = dos + TILE, *vs = ks + TILE;
  float* dss = vs + TILE;
  __shared__ int ids_q[FB], ids_kv[FB];
  __shared__ float lse_s[FB], di_s[FB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * FB, bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const T* k = slice<T>(p.k, p.st_k, bi, hi);
  const T* v = slice<T>(p.v, p.st_v, bi, hi);
  load_tile(qs, slice<T>(p.q, p.st_q, bi, hi), p.st_q.s, q0, p.sq);
  load_tile(dos, slice<T>(p.dout, p.st_do, bi, hi), p.st_do.s, q0, p.sq);
  load_ids(ids_q, p.seg_q, bi, q0, p.sq);
  load_rows(lse_s, p.lse_in + (long long)bh * p.sq, q0, p.sq);
  load_rows(di_s, p.di + (long long)bh * p.sq, q0, p.sq);

  // Rows r = q0 + ty + 16 i, columns d = tx + 16 j.
  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
  const int n_tiles = kv_tiles(p, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FB;
    __syncthreads();
    load_tile(ks, k, p.st_k.s, k0, p.sk);
    load_tile(vs, v, p.st_v.s, k0, p.sk);
    load_ids(ids_kv, p.seg_kv, bi, k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < FD; ++dd) {
      float a[4], a2[4], b[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * FP + dd];
        a2[i] = dos[(ty + 16 * i) * FP + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(tx + 16 * j) * FP + dd];
        b2[j] = vs[(tx + 16 * j) * FP + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i, rl = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float ds = 0.f;
        if (r < p.sq && c < p.sk) {
          const float val = masked_logit(p, s[i][j], r, c, ids_q[rl],
                                         ids_kv[tx + 16 * j]);
          ds = expf(val - lse_s[rl]) * (dp[i][j] - di_s[rl]) * p.scale;
        }
        dss[rl * FP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FB; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * FP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[kk * FP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq[i][j] = fmaf(a[i], b[j], dq[i][j]);
    }
  }
  T* dq_out = slice_out<T>(p.dq, p.st_dq, bi, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq_out[(long long)r * p.st_dq.s + tx + 16 * j] = from_f<T>(dq[i][j]);
  }
}

// Launches kernel over grid (tiles, b * h) with `tiles` shared-memory tiles;
// above 48 KB the kernel has to be allowed the dynamic shared memory first.
template <typename Kernel>
int launch(Kernel kernel, int row_tiles, int bh, int tiles,
           const FlashParams& p, cudaStream_t st) {
  const int bytes = tiles * TILE * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(row_tiles, bh), FNT, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace
}  // namespace fewbit

// q (b, h, sq, d), k and v (b, h, sk, d) of f32 or bf16 (is_bf16), d 64
// only, any (b, h, s) strides; seg_q (b, sq) and seg_kv (b, sk) int32 or
// both null.  Writes o (q's shape, its own strides) and lse (b, h, sq) f32
// contiguous.  Returns the CUDA error of the launch (0 when it was
// accepted), -1 for another d (nothing launched).  The CUDA-core kernel
// that flash_forward.cu's fewbit_flash_forward replaced; the same
// arguments.
extern "C" int fewbit_flash_forward_simt(const void* q, const void* k,
                                         const void* v, const void* seg_q,
                                         const void* seg_kv, void* o,
                                         void* lse, const void* strides,
                                         int b, int h, int sq, int sk,
                                         int d, int causal, float scale,
                                         int is_bf16, void* stream) {
  using namespace fewbit;
  if (d != FD) return -1;
  FlashParams p =
      make_params(q, k, v, seg_q, seg_kv,
                  static_cast<const long long*>(strides), h, sq, sk, causal,
                  scale);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(flash_forward_simt_kernel<__nv_bfloat16>, cdiv(sq, FB),
                  b * h, 4, p, st);
  return launch(flash_forward_simt_kernel<float>, cdiv(sq, FB), b * h, 4, p,
                st);
}

// As above, with the forward's lse, the output gradient dout (any strides)
// and di = sum(dout * o) (b, h, sq) f32 contiguous; writes dk and dv (-1
// for another d, as above).  The CUDA-core kernel that flash_backward.cu's
// fewbit_flash_backward_dkv replaced; the same arguments.
extern "C" int fewbit_flash_backward_dkv_simt(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* lse, const void* dout, const void* di,
    void* dk, void* dv, const void* strides, int b, int h, int sq, int sk,
    int d, int causal, float scale, int is_bf16, void* stream) {
  using namespace fewbit;
  if (d != FD) return -1;
  FlashParams p = make_backward_params(q, k, v, seg_q, seg_kv, lse, dout, di,
                                       strides, h, sq, sk, causal, scale);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(flash_backward_dkv_kernel<__nv_bfloat16>, cdiv(sk, FB),
                  b * h, 6, p, st);
  return launch(flash_backward_dkv_kernel<float>, cdiv(sk, FB), b * h, 6, p,
                st);
}

// As fewbit_flash_backward_dkv_simt; writes dq.
extern "C" int fewbit_flash_backward_dq_simt(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* lse, const void* dout, const void* di,
    void* dq, const void* strides, int b, int h, int sq, int sk, int d,
    int causal, float scale, int is_bf16, void* stream) {
  using namespace fewbit;
  if (d != FD) return -1;
  FlashParams p = make_backward_params(q, k, v, seg_q, seg_kv, lse, dout, di,
                                       strides, h, sq, sk, causal, scale);
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(flash_backward_dq_kernel<__nv_bfloat16>, cdiv(sq, FB),
                  b * h, 5, p, st);
  return launch(flash_backward_dq_kernel<float>, cdiv(sq, FB), b * h, 5, p,
                st);
}
