// Fused dense + activation + few-bit codes + output countsketch: z = x @ w
// + b, y = act(z), the code of z (against the LUT's interior borders, or a
// piecewise function's predicate on the f32 z) packed into bit planes, and
// sk_y[b] = sum_{r = b mod k_eff} sigma_r y_r.
// With sigma_x (kernel 2'), also the input countsketch
// sk_x[b] = sum_{r = b mod k_eff} sigma_x,r x_r, from the kernel's own read
// of x.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_dense_act_sketch
// (_dense_act_sketch_kernel through _kernel_no_skx, and through _kernel_skx
// with sigma_x), the forward of the few-bit FFN block.
//
// What bounds it on this card: at the FFN up projection (8192 x 768 ->
// 3072) the product is 38.7 GFLOP against 170 MB of f32 traffic (x 25, w 9,
// y 101, codes 9, sketch 25; 90 MB in bf16).  The tensor cores bound it:
// 0.039 ms in bf16 at 989 TFLOP/s, 0.234 ms in f32 as three TF32 products
// at 495 TFLOP/s, against 0.027-0.051 ms for the bytes at 3.35 TB/s.  The
// epilogue adds one erff and 2^bits - 1 compares per element and is not
// overlapped with the block's own wgmma; the (N, M) pre-activation never
// reaches device memory.
//
// Design, without sigma_x (dense_act_sketch_wgmma_kernel): the mainloop of
// ffn_gemm.cuh (TMA ring, two consumer warpgroups on wgmma, 128 buckets x BN
// columns per block, the block loops over the N / k_eff passes), and per
// pass, on the accumulator fragment:
// - z = acc + b in f32, y = act(z) stored as T two columns at a time; the
//   code of z counts the borders below it, four borders to a 16-byte read
//   of the table and eight elements to a read (the block has 8 consumer
//   warps, so the epilogue is bound by latency: independent elements are
//   interleaved), or is a piecewise function's predicate.  The kernel is
//   built twice: for GELU with border codes (ANY false, gelu_exact inline)
//   and for any other spec (ANY: act_forward_any, one call per element,
//   and the predicate);
// - sk += sigma_row * (y as stored), in the thread's own f32 accumulators
//   (shared memory, ffn_gemm.cuh), stored once, by the last pass;
// - the codes.  A packed word holds 32 consecutive rows of one column, but a
//   warp's fragment holds 16 rows (thread (g, t): rows g and g + 8 of the
//   warp's 16, columns 8 i + 2 t + e).  Each thread puts its two rows' bits
//   of a plane at bits g and g + 8 of a 16-bit half, two planes to a
//   register; three xor-shuffles (4, 8, 16) OR the halves over the 8 lanes
//   that share a column, and the even and the odd warp of a 32-row group
//   store the low and the high half of the word (2-byte stores; lane
//   g = i mod 8 stores column group i, so the stores are spread over the
//   warp).  No shared-memory staging and no block-wide barrier.
// Registers per thread (nvcc 12.8, -Xptxas -v; the cap of a 288-thread
// block is 168): f32 144 at both tile widths, bf16 128 (BN 96) and 112
// (BN 64); no spills.  On an H100 SXM at 700 W the path shape takes about
// 0.51 ms in f32 (46% of the bound) and 0.26 ms in bf16 (15%), a quarter to
// two fifths of it the epilogue's arithmetic.
//
// With sigma_x (kernel 2', dense_act_sketch_wgmma_kernel<T, BN, true>): the
// same mainloop and epilogue, and the countsketch of x from the A tiles of
// the ring, as kernel 1 takes its own (SketchSlice in hopper_gemm.cuh):
// column tile j of J owns sk_x columns [j K / J, (j + 1) K / J) of its 128
// buckets, an f32 slice in shared memory beside kernel 2's block (12 KB at
// 768 -> 3072, BN 96); a consumer thread adds sigma_x x of the raw operand
// (f32 x, not its TF32 halves) for a fixed 16 (f32) or 32 (bf16) elements
// of each k tile that holds the slice, between issuing the tile's first
// wgmma group and handing its stage back (fg_consume_pass's on_tile), and
// writes its own elements once, after the last pass.  sigma_x is read where
// it is used, so that f32's 144 registers do not grow (loading it a pass
// ahead and handing it round by shuffles made no difference).  The host
// (dense_act_sketch_x_route in ops/kernels.py) takes 96, then 64, where
// the slice fits beside the block, and otherwise runs kernel 2 and then
// kernel 1's separate sketch pass on x (fewbit_input_sketch).
//
// The first, CUDA-core design stays as dense_act_sketch_x_kernel (entry
// fewbit_dense_act_sketch_x_simt), on no path, what kernel 2' is measured
// against: a block owns one tile of BM buckets and BN columns on the
// CUDA-core gemm_tile of common.cuh, only the first column tile's blocks sum
// sk_x into a global f32 scratch, codes are staged in shared memory and
// packed by __ballot_sync.  No model path runs kernel 2' in either design.
#include <type_traits>

#include "ffn_gemm.cuh"

namespace fewbit {
namespace {

template <typename T>
struct K2Params {
  const T* bias;         // (m,) or null
  const float* borders;  // (n_borders,)
  const float* sigma;    // (n,)
  T* y;                  // (n, m)
  uint16_t* packed;      // (bits, words, m) 32-bit words, as their halves
  T* sk;                 // (k_eff, m)
  int kdim, m, words, bits, n_borders;
  int passes, pass_stride;  // rows of pass c: c pass_stride + 128 blockIdx.x
  // Kernel 2' only: sigma_x (n,), sk_x (k_eff, kdim), the column tiles and
  // the slice's row stride (SketchSlice).
  const float* sigma_x;
  T* skx;
  int jt, kcp;
};

// Dynamic shared memory of a block of kernel 2': kernel 2's (fg_smem) and
// the x sketch's slice, 128 buckets of ceil(K / J) f32 columns (J = m / bn
// column tiles), past the barriers; -1 where the width is not built or
// does not divide m, or the block would exceed FG_SMEM_LIMIT.
// _sketch_x_smem in fewbit_tpu_torch/ops/kernels.py computes the same;
// fewbit_dense_act_sketch_x_smem exports this one.
template <typename T>
int sketch_x_smem(int kdim, int m, int bn) {
  const int base = fg_smem_or_refuse<T>(bn);
  if (base < 0 || m <= 0 || m % bn || kdim <= 0) return -1;
  const int jt = m / bn;
  const int smem = base + FG_BM * ((kdim + jt - 1) / jt) * 4;
  return smem > FG_SMEM_LIMIT ? -1 : smem;
}

template <typename T, int BN, bool SKX, bool ANY>
__global__ void __launch_bounds__(FG_THREADS, 1)
    dense_act_sketch_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                                  const __grid_constant__ CUtensorMap map_b,
                                  const __grid_constant__ CUtensorMap map_b_lo,
                                  K2Params<T> p, ActArgs act) {
  extern __shared__ uint8_t smem_raw[];
  const FgSmem<T, BN> s(smem_raw);
  fg_init(s, p.borders, p.n_borders, __int_as_float(0x7f800000));  // +inf
  const int bucket0 = blockIdx.x * FG_BM, col0 = blockIdx.y * BN;
  const int k_tiles = p.kdim / Operand<T>::BK;
  if (threadIdx.x >= FG_CONSUMERS) {  // the producer warp; one thread loads
    if (threadIdx.x == FG_CONSUMERS)
      fg_produce(s, &map_a, &map_b, &map_b_lo, p.passes, p.pass_stride,
                 bucket0, col0, k_tiles);
    return;
  }
  const FgThread th;
  float* ska = s.ska + threadIdx.x;  // element idx at ska[idx * FG_CONSUMERS]
  const int word_half = th.warp & 1;  // the half of the words it writes
  const int border_quads = (p.n_borders + 3) / 4;
  // Kernel 2': this block's slice of sk_x, past the barriers.
  const SketchSlice<T> xs(th.wg, threadIdx.x % 128, blockIdx.y, p.jt,
                          p.kdim);
  float* slice = reinterpret_cast<float*>(s.empty + FG_STAGES);
  int st = 0;
  uint32_t ph = 0;
  for (int c = 0; c < p.passes; ++c) {
    const int r0 = c * p.pass_stride + bucket0;
    const bool first = c == 0, last = c == p.passes - 1;
    float acc[BN / 2];
    if constexpr (SKX) {
      // sigma_x of the thread's rows read where they are used, not held
      // across the pass: f32 has 24 registers to spare.
      fg_consume_pass<T, BN>(
          acc, s, th, k_tiles, st, ph, nullptr,
          [&](const uint8_t* tile_a, int kt) {
            if (xs.owns(kt))
              xs.add(tile_a, kt, slice, p.kcp, first, [&](int i) {
                return __ldg(p.sigma_x + r0 + xs.row(i));
              });
            __syncwarp();
          });
    } else {
      fg_consume_pass<T, BN>(acc, s, th, k_tiles, st, ph);
    }
    float sg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sg[h] = p.sigma[r0 + th.row + 8 * h];
    // The 32-row group of this warp: rows 32 (warp / 2) .. + 31 of the
    // warpgroup's 64.
    const size_t word_row = (r0 + 64 * th.wg + 32 * (th.warp / 2)) / 32;
    // Two column groups (8 elements) at a time: with 8 consumer warps on
    // the SM the epilogue is bound by latency, not throughput, so
    // independent elements are interleaved, and one 16-byte table read
    // serves all 8.
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += 2) {
      float z[8];        // [u][h][e] of column groups i0 + u
      unsigned code[8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = col0 + 8 * (i0 + u) + 2 * th.t;
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
      // The table is padded with +inf to a multiple of 4 borders.
      for (int k = 0; k < border_quads; ++k) {
        const float4 bd = reinterpret_cast<const float4*>(s.table)[k];
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
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u, col = col0 + 8 * i + 2 * th.t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float yv[2], skv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * i + 2 * h + e;
            const float ze = z[4 * u + 2 * h + e];
            if constexpr (ANY)
              yv[e] = round_to<T>(
                  act_forward_any(act.act, act.a0, act.a1, ze));
            else
              yv[e] = round_to<T>(gelu_exact(ze));
            // The sketch sums y as stored, widened to f32.
            skv[e] =
                fmaf(sg[h], yv[e], first ? 0.f : ska[idx * FG_CONSUMERS]);
            if (!last) ska[idx * FG_CONSUMERS] = skv[e];
          }
          store2(p.y + (size_t)(r0 + th.row + 8 * h) * p.m + col, yv[0],
                 yv[1]);
          if (last)
            store2(p.sk + (size_t)(bucket0 + th.row + 8 * h) * p.m + col,
                   skv[0], skv[1]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // The codes of column col + e: row g in bits 0..7, row g + 8 in
          // bits 8..15.
          const uint32_t rows = code[4 * u + e] | (code[4 * u + 2 + e] << 8);
#pragma unroll
          for (int q = 0; q < 3; ++q) {  // planes 2 q and 2 q + 1
            if (2 * q < p.bits) {
              // Bit b of both rows' codes at bits g and g + 8 of b's half.
              uint32_t v = (((rows >> (2 * q)) & 0x101u) << th.g) |
                           (((rows >> (2 * q + 1)) & 0x101u) << (th.g + 16));
              v |= __shfl_xor_sync(0xffffffffu, v, 4);
              v |= __shfl_xor_sync(0xffffffffu, v, 8);
              v |= __shfl_xor_sync(0xffffffffu, v, 16);
              if (th.g == (i & 7)) {
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                  const int b = 2 * q + o;
                  if (b < p.bits)
                    p.packed[(((size_t)b * p.words + word_row) * p.m + col +
                              e) * 2 +
                             word_half] =
                        static_cast<uint16_t>(v >> (16 * o));
                }
              }
            }
          }
        }
      }
    }
  }
  if constexpr (SKX)
    xs.store(slice, p.kcp, p.skx + (size_t)bucket0 * p.kdim, p.kdim);
}

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
    dense_act_sketch_x_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ bias,
                              const float* __restrict__ borders, int n_borders,
                              ActArgs act, const float* __restrict__ sigma,
                              int n, int kdim,
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
          const T yt =
              from_f<T>(act_forward_any(act.act, act.a0, act.a1, z));
          y[(size_t)row * m + col] = yt;
          code = any_code(act, z, bord, n_borders);
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

template <typename T, int BN, bool SKX, bool ANY>
int launch_wgmma_bn(const CUtensorMap& ma, const CUtensorMap& mb,
                    const CUtensorMap& mb_lo, const K2Params<T>& p,
                    const ActArgs& act, int k_eff, int smem,
                    cudaStream_t st) {
  auto kernel = dense_act_sketch_wgmma_kernel<T, BN, SKX, ANY>;
  static unsigned allowed = 0;
  const int err =
      fg_allow_smem(reinterpret_cast<const void*>(kernel), allowed);
  if (err != 0) return err;
  kernel<<<dim3(k_eff / FG_BM, p.m / BN), FG_THREADS, smem, st>>>(
      ma, mb, mb_lo, p, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgmma(const void* x, const void* w, int w_trans, const void* bias,
                 const float* borders, int n_borders, const ActArgs& act,
                 const float* sigma,
                 void* y, void* packed, void* sk, const float* sigma_x,
                 void* skx, void* w_prep, int n, int kdim, int m, int k_eff,
                 int bits, int bn, cudaStream_t st) {
  if (n_borders < 0 || n_borders > FG_TABLE || bits < 1 || bits > 6 ||
      !act_known(act, false))
    return -1;
  const bool skx_on = sigma_x != nullptr;
  if (skx_on && skx == nullptr) return -1;
  const int smem = skx_on ? sketch_x_smem<T>(kdim, m, bn)
                          : fg_smem_or_refuse<T>(bn);
  if (smem < 0) return -1;
  CUtensorMap ma, mb, mb_lo;
  const int rc = fg_operands<T>(x, w, w_trans, w_prep, n, kdim, m, k_eff, bn,
                                &ma, &mb, &mb_lo, st);
  if (rc != 0) return rc;
  const int jt = m / bn;
  K2Params<T> p{static_cast<const T*>(bias),
                borders,
                sigma,
                static_cast<T*>(y),
                static_cast<uint16_t*>(packed),
                static_cast<T*>(sk),
                kdim,
                m,
                (n + 31) / 32,
                bits,
                n_borders,
                n / k_eff,
                k_eff,
                sigma_x,
                static_cast<T*>(skx),
                jt,
                (kdim + jt - 1) / jt};
  // The ANY build for every spec but GELU with border codes.
  const bool any = act.act != ACT_GELU || act.kind != CODE_BORDERS;
  const auto go = [&](auto bn_c, auto skx_c, auto any_c) {
    return launch_wgmma_bn<T, decltype(bn_c)::value, decltype(skx_c)::value,
                           decltype(any_c)::value>(ma, mb, mb_lo, p, act,
                                                   k_eff, smem, st);
  };
  using B96 = std::integral_constant<int, 96>;
  using B64 = std::integral_constant<int, 64>;
  using Y = std::true_type;
  using N = std::false_type;
  if (skx_on)
    return bn == 96 ? (any ? go(B96(), Y(), Y()) : go(B96(), Y(), N()))
                    : (any ? go(B64(), Y(), Y()) : go(B64(), Y(), N()));
  return bn == 96 ? (any ? go(B96(), N(), Y()) : go(B96(), N(), N()))
                  : (any ? go(B64(), N(), Y()) : go(B64(), N(), N()));
}

template <typename T>
void launch_x(const void* x, const void* w, int w_trans, const void* bias,
            const float* borders, int n_borders, const ActArgs& act,
            const float* sigma, void* y,
            uint32_t* packed, void* sk, const float* sigma_x,
            float* skx_acc, void* skx_out, int n, int kdim, int m, int k_eff,
            int bits, cudaStream_t st) {
  dim3 grid((m + BN - 1) / BN, k_eff / BM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  if (w_trans)
    dense_act_sketch_x_kernel<T, true><<<grid, NT, 0, st>>>(
        xt, wt, bt, borders, n_borders, act, sigma, n, kdim, m, k_eff, bits,
        static_cast<T*>(y), packed, static_cast<T*>(sk), sigma_x, skx_acc,
        static_cast<T*>(skx_out));
  else
    dense_act_sketch_x_kernel<T, false><<<grid, NT, 0, st>>>(
        xt, wt, bt, borders, n_borders, act, sigma, n, kdim, m, k_eff, bits,
        static_cast<T*>(y), packed, static_cast<T*>(sk), sigma_x, skx_acc,
        static_cast<T*>(skx_out));
}

}  // namespace
}  // namespace fewbit

// x (n, kdim), w the logical (kdim, m) weight (stored transposed when
// w_trans), bias (m,) or null, borders (n_borders,) f32 with n_borders < 64,
// act_args the host address of an ActArgs (common.cuh: border or predicate
// codes, f32 arguments), sigma (n,) f32; outputs y (n, m), packed (bits,
// ceil(n / 32), m) 32-bit words and sk (k_eff, m).  k_eff must be a
// multiple of 128 that divides n,
// kdim a multiple of 128, m of bn (the host's tile width: 96 or 64), and
// bits at most 6; x and a bf16 transposed w 16-byte aligned; w_prep is
// scratch for the K-major B: (2, m, kdim) for f32 (hi, lo), (m, kdim) for
// bf16 with w_trans = 0, null for bf16 with w_trans = 1.
//
// Without sigma_x, kernel 2 at ffn_gemm_route's width.  With sigma_x (n,)
// f32, kernel 2' on its fused route (dense_act_sketch_x_route): also sk_x
// into skx (k_eff, kdim) of x's type, at a width whose block holds the
// slice (fewbit_dense_act_sketch_x_smem).
//
// Returns cudaGetLastError() after the launches, -1 for arguments the
// kernels do not take (nothing launched), -2 when the TMA descriptors cannot
// be encoded.
extern "C" int fewbit_dense_act_sketch(
    const void* x, const void* w, int w_trans, const void* bias,
    const void* borders, int n_borders, const void* act_args,
    const void* sigma, void* y, void* packed, void* sk, const void* sigma_x,
    void* skx, void* w_prep, int n, int kdim, int m, int k_eff, int bits,
    int bn, int is_bf16, void* stream) {
  const fewbit::ActArgs act = *static_cast<const fewbit::ActArgs*>(act_args);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bd = static_cast<const float*>(borders);
  const float* sg = static_cast<const float*>(sigma);
  const float* sgx = static_cast<const float*>(sigma_x);
  if (is_bf16)
    return fewbit::launch_wgmma<__nv_bfloat16>(
        x, w, w_trans, bias, bd, n_borders, act, sg, y, packed, sk, sgx, skx,
        w_prep, n, kdim, m, k_eff, bits, bn, st);
  return fewbit::launch_wgmma<float>(x, w, w_trans, bias, bd, n_borders, act,
                                     sg, y, packed, sk, sgx, skx, w_prep, n,
                                     kdim, m, k_eff, bits, bn, st);
}

// Kernel 2''s function by the first, CUDA-core kernel (on no
// path; what the tensor-core kernel is measured against): the arguments of
// fewbit_dense_act_sketch without w_prep and bn, sk_x summed in skx_acc
// (k_eff, kdim) f32, which is the result when skx_out is null (f32 models)
// and is converted into skx_out otherwise (bf16).  Returns
// cudaGetLastError() after the launch.
extern "C" int fewbit_dense_act_sketch_x_simt(
    const void* x, const void* w, int w_trans, const void* bias,
    const void* borders, int n_borders, const void* act_args,
    const void* sigma, void* y, void* packed, void* sk, const void* sigma_x,
    void* skx_acc, void* skx_out, int n, int kdim, int m, int k_eff, int bits,
    int is_bf16, void* stream) {
  const fewbit::ActArgs act = *static_cast<const fewbit::ActArgs*>(act_args);
  if (!fewbit::act_known(act, false))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bd = static_cast<const float*>(borders);
  const float* sg = static_cast<const float*>(sigma);
  const float* sgx = static_cast<const float*>(sigma_x);
  float* acc = static_cast<float*>(skx_acc);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  if (is_bf16)
    fewbit::launch_x<__nv_bfloat16>(x, w, w_trans, bias, bd, n_borders, act,
                                    sg, y, pk, sk, sgx, acc, skx_out, n, kdim,
                                    m, k_eff, bits, st);
  else
    fewbit::launch_x<float>(x, w, w_trans, bias, bd, n_borders, act, sg, y,
                            pk, sk, sgx, acc, skx_out, n, kdim, m, k_eff,
                            bits, st);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory that a block of the FFN kernels (kernel 2, and
// fewbit_matmul_lut_backward) takes at tile width bn, or -1 where they
// refuse it (a width not built, or over the block's limit).  Launches
// nothing.
extern "C" int fewbit_ffn_gemm_smem(int bn, int is_bf16) {
  return is_bf16 ? fewbit::fg_smem_or_refuse<__nv_bfloat16>(bn)
                 : fewbit::fg_smem_or_refuse<float>(bn);
}

// The dynamic shared memory that a block of kernel 2' takes at (kdim, m,
// bn), or -1 where it refuses it (sketch_x_smem).  Launches nothing.
extern "C" int fewbit_dense_act_sketch_x_smem(int kdim, int m, int bn,
                                              int is_bf16) {
  return is_bf16 ? fewbit::sketch_x_smem<__nv_bfloat16>(kdim, m, bn)
                 : fewbit::sketch_x_smem<float>(kdim, m, bn);
}
