// Fused dense + activation + few-bit codes: z = x @ w + b, y = act(z), and
// the interval code of z against the LUT's interior borders packed into bit
// planes.  No sketch: the caller keeps x itself, or sketches it apart.
//
// Replaces fewbit_tpu/ops/pallas_kernels.py: fused_dense_act
// (_dense_act_kernel), the forward of the fused dense + few-bit activation
// (the GPT FFN's up projection), and the first of the four schedules of that
// function in tools/exp_megakernel.py: make_variant / variant_kernel, the
// (row, column, k) grid with the accumulator carried over the k steps and
// the epilogue on the last.  The other three are dense_act_direct.cu and
// dense_act_pipelined.cu; the epilogue they share is dense_act_epilogue.cuh.
//
// What bounds it on this card: at the GPT-2 small FFN up projection
// (8192 x 768 -> 3072) the product is 38.7 GFLOP against about 135 MB of
// f32 traffic: the tensor cores bound it, 0.039 ms in bf16 at 989 TFLOP/s
// and 0.234 ms in f32 as three TF32 products at 495 TFLOP/s.  The epilogue
// adds one erff and 2^bits - 1 compares per element and writes y and
// bits / 8 bytes of codes; the (N, M) pre-activation never reaches device
// memory.
//
// The k loop (dense_act_kloop_kernel): the mainloop of ffn_gemm.cuh with
// one pass.  One block per 128 x BN tile of y; the producer thread streams
// the k tiles of x and w through the ring of 4 TMA stages; the two consumer
// warpgroups carry the f32 accumulator in registers over the k steps (bf16
// operands from shared memory, f32 as three TF32 products) and run the
// epilogue after the last.  Both warpgroups of the one block an SM holds
// reach the epilogue together, so no wgmma runs under it.  Without EPILOGUE
// the kernel stores z and zero words in plane 0: the ablation that measures
// the epilogue's share.  On an H100 SXM at 700 W the shape above takes 0.51
// ms in f32 (46% of the bound), 0.262 ms in bf16 (15%), and without the
// epilogue 0.37 and 0.124 ms.  Registers 96-123 (f32), 64-102 (bf16), no
// spills.
//
// The CUDA-core kernel (dense_act_kernel, entry fewbit_dense_act_simt): the
// first, simple design on gemm_tile of common.cuh, one block per 128 x 128
// tile of y, bound by its own FMA rate.  Codes go through shared
// memory so that one warp holds 32 consecutive rows of one column, and each
// bit plane is one __ballot_sync: word [b, w, m] holds bit b of the codes of
// rows 32 w .. 32 w + 31 of column m, the layout the backward
// (activation.cu) decodes.  Rows past N are masked: they read as zero, give
// zero bits and are not written.  No model path runs it; it is what the
// tensor-core schedules are measured against.
#include <type_traits>

#include "dense_act_epilogue.cuh"

namespace fewbit {
namespace {

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(NT)
    dense_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias,
                     const float* __restrict__ borders, int n_borders,
                     ActArgs act, int n, int kdim, int m, int bits,
                     T* __restrict__ y,
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
        y[(size_t)row * m + col] =
            from_f<T>(act_forward_any(act.act, act.a0, act.a1, z));
        code = any_code(act, z, bord, n_borders);
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
            const float* borders, int n_borders, const ActArgs& act, void* y,
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

template <typename TI, typename TO, int BN, bool EPILOGUE, bool ANY>
__global__ void __launch_bounds__(FG_THREADS, 1)
    dense_act_kloop_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_b_lo,
                           DaParams<TI, TO> p, ActArgs act) {
  extern __shared__ uint8_t smem_raw[];
  const FgSmem<TI, BN> s(smem_raw);
  fg_init(s, p.borders, p.n_borders, __int_as_float(0x7f800000));  // +inf
  const int row0 = blockIdx.x * FG_BM, col0 = blockIdx.y * BN;
  const int k_tiles = p.kdim / Operand<TI>::BK;
  if (threadIdx.x >= FG_CONSUMERS) {  // the producer warp; one thread loads
    if (threadIdx.x == FG_CONSUMERS)
      fg_produce(s, &map_a, &map_b, &map_b_lo, 1, 0, row0, col0, k_tiles);
    return;
  }
  const FgThread th;
  int st = 0;
  uint32_t ph = 0;
  float acc[BN / 2];
  fg_consume_pass<TI, BN>(acc, s, th, k_tiles, st, ph);
  da_epilogue<TI, TO, BN, EPILOGUE, ANY>(
      acc, p, act, s.table, row0 + 64 * th.wg, col0, th.warp, th.g, th.t,
      DaStoreGlobal<TO>{p.y, p.n, p.m});
}

template <typename TI, typename TO, int BN, bool EPILOGUE, bool ANY>
int launch_kloop(const CUtensorMap& ma, const CUtensorMap& mb,
                 const CUtensorMap& mb_lo, const DaParams<TI, TO>& p,
                 const ActArgs& act, cudaStream_t st) {
  auto kernel = dense_act_kloop_kernel<TI, TO, BN, EPILOGUE, ANY>;
  static unsigned allowed = 0;
  const int err =
      fg_allow_smem(reinterpret_cast<const void*>(kernel), allowed);
  if (err != 0) return err;
  kernel<<<dim3((p.n + FG_BM - 1) / FG_BM, p.m / BN), FG_THREADS,
           fg_smem(Operand<TI>::PARTS, BN), st>>>(ma, mb, mb_lo, p, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit

// The CUDA-core kernel.  x (n, kdim), w the logical (kdim, m) weight (stored
// transposed when w_trans), bias (m,) or null, borders (n_borders,) f32 with
// n_borders < 64, act_args the host address of an ActArgs (common.cuh:
// border or predicate codes, f32 arguments); outputs y (n, m) and
// packed (bits, ceil(n / 32), m) 32-bit words, bits in 1..6.  Any n (ragged
// rows are masked); ceil(n / 128) blocks must fit the grid's y extent
// (n <= 65535 * 128).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without launching for an unknown act, bits or row count.
extern "C" int fewbit_dense_act_simt(const void* x, const void* w, int w_trans,
                                const void* bias, const void* borders,
                                int n_borders, const void* act_args, void* y,
                                void* packed, int n, int kdim, int m, int bits,
                                int is_bf16, void* stream) {
  using namespace fewbit;
  const ActArgs act = *static_cast<const ActArgs*>(act_args);
  if (!act_known(act, false) || bits < 1 || bits > 6 || n_borders > 63 ||
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

// The k loop on the tensor cores.  Arguments as fewbit_dense_act_simt's,
// and: kdim a multiple of 128, m of bn (the host's tile width, 96 or 64),
// x and a bf16 transposed w 16-byte aligned; w_prep is scratch for the
// K-major B: (2, m, kdim) for f32 (hi, lo), (m, kdim) for bf16 with
// w_trans = 0, null for bf16 with w_trans = 1.  in_bf16 and out_bf16 name
// the element types of x, w, bias and of y: f32 -> f32, bf16 -> bf16 or
// bf16 -> f32.  Without `epilogue`, y = z and packed is one plane
// (bits = 1) of zero words.
// Returns cudaGetLastError() after the launches, -1 for arguments the
// kernel does not take (nothing launched), -2 when the TMA descriptors
// cannot be encoded.
extern "C" int fewbit_dense_act_kloop(const void* x, const void* w,
                                      int w_trans, const void* bias,
                                      const void* borders, int n_borders,
                                      const void* act_args, void* y,
                                      void* packed, void* w_prep, int n,
                                      int kdim, int m, int bits, int bn,
                                      int in_bf16, int out_bf16, int epilogue,
                                      void* stream) {
  using namespace fewbit;
  const ActArgs act = *static_cast<const ActArgs*>(act_args);
  if (!da_args_ok(n_borders, bits, act, epilogue)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return da_dispatch_types(in_bf16, out_bf16, [&](auto ti, auto to) {
    using TI = decltype(ti);
    using TO = decltype(to);
    if (fg_smem_or_refuse<TI>(bn) < 0) return -1;
    CUtensorMap ma, mb, mb_lo;
    const int rc = fg_operands_any_rows<TI>(x, FG_BM, w, w_trans, w_prep, n,
                                            kdim, m, bn, &ma, &mb, &mb_lo, st);
    if (rc != 0) return rc;
    const DaParams<TI, TO> p = da_params<TI, TO>(bias, borders, n_borders, y,
                                                 packed, n, kdim, m, bits);
    const bool any = da_any(act);
    const auto go = [&](auto bn_c, auto epi_c, auto any_c) {
      return launch_kloop<TI, TO, decltype(bn_c)::value,
                          decltype(epi_c)::value, decltype(any_c)::value>(
          ma, mb, mb_lo, p, act, st);
    };
    using B96 = std::integral_constant<int, 96>;
    using B64 = std::integral_constant<int, 64>;
    using Y = std::true_type;
    using N = std::false_type;
    if (bn == 96)
      return !epilogue ? go(B96(), N(), N())
                       : (any ? go(B96(), Y(), Y()) : go(B96(), Y(), N()));
    return !epilogue ? go(B64(), N(), N())
                     : (any ? go(B64(), Y(), Y()) : go(B64(), Y(), N()));
  });
}
