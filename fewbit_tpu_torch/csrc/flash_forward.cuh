// Flash attention's forward on the tensor cores (F1): both products of each
// tile a wgmma, the online softmax in registers.  The kernel and its
// launcher, templated on the head dimension; flash_forward*.cu instantiate
// them at every multiple of 16 up to 128, and flash_forward.cu holds the
// entry point.
//
// Replaces JAX's Pallas TPU library kernel _flash_attention_impl
// (jax/experimental/pallas/ops/tpu/flash_attention.py).  With S = sm_scale
// Q K^T (scaled after the product) and DEFAULT_MASK_VALUE added where the
// causal or segment mask is false: O = softmax(S) V in q's type and
// strides, and lse, the f32 log-sum-exp of each row, which F2 and F3 read.
// Keys past sk take no part.
//
// What bounds it on this card: at GPT-2 small (8 x 12 heads, seq 1024,
// causal) it is 2 products of 2 * 64 operations on each of the 50.4 M
// unmasked pairs, 12.9 GFLOP, against 50 MB of f32 q, k, v and o: the
// tensor cores, 0.013 ms in bf16 at 989 TFLOP/s (where the 25 MB of bf16
// operands take 0.015 ms at 3.35 TB/s) and 0.078 ms in f32 as three TF32
// products at 495 TFLOP/s.
//
// Design (flash_backward.cuh's F3 with one own operand; shared pieces in
// flash_hopper.cuh; the shapes below are those of head dimension 64, and
// hb_tiles gives the others'):
// - A block owns 128 query rows, 64 per consumer warpgroup, loaded once by
//   TMA through a 4-D map over q's own strides, and loops over 64-row kv
//   tiles, under the causal mask up to the diagonal.  The blocks with the
//   most tiles are scheduled first.  Nothing is summed across blocks: no
//   atomics, o and lse are bitwise repeatable.  Under the causal mask a
//   warpgroup skips the products of a tile that lies wholly past its rows.
// - S = Q K^T contracts over d: K is K-major as it lies in memory.  bf16:
//   K and V tiles by TMA into a ring of four stages; both operands of S
//   from shared memory, Q as A.  f32 (three TF32 products): the producer
//   warpgroup copies K raw with cp.async and splits it in place into hi
//   and lo planes; each consumer warpgroup splits its Q rows in place once,
//   so A comes from shared memory too (held as fragments in registers over
//   the loop, Q spilled: 136 B, and the results went wrong).
// - The online softmax works on the accumulator fragment: a thread holds
//   two rows (g, g + 8) of its warp's 16, 16 columns each; a row's max
//   reduces over the four lanes that share it, its sum stays a per-thread
//   partial until the end.  The running max is kept in the units of S:
//   DEFAULT_MASK_VALUE times log2 e overflows f32, so a masked tile takes
//   the difference to the max first and scales it by log2 e for exp2 after.
//   The max moves only when a row of the warp gains more than 2^8 on it:
//   most tiles then skip o's rescale.
//   Only diagonal, ragged and mixed-id tiles take the masked path.  A row
//   whose every key is masked averages V over them, as the plain version.
// - P never goes through shared memory: the accumulator fragment is the A
//   operand of O += P V from registers, rescaled O in registers too.  P V
//   contracts over the kv rows, so V is MN-major: bf16 wgmma reads the TMA
//   tile through its transpose bit; for f32 the producer splits V into a
//   staging pair of planes and writes them transposed and k-permuted into
//   the stage (transpose_planes), so the fragment needs no shuffle.  With
//   one own operand and one 64 x 64 product per warpgroup, f32 has room for
//   two stages (Q's planes 64 KB + 2 x 64 KB + 32 KB of staging).
// - bf16 runs two blocks an SM (a producer warp, not a warpgroup: 288
//   threads of 112 registers), so that one block's exp overlaps the
//   other's products and its prologue and stores the other's tiles.  exp2
//   is the special function unit's, ex2.approx.ftz.
// - lse = m + log(l) at the end, o = acc / l by paired stores in q's
//   strides.
// Other head dimensions: the same kernel with its planes and products over
// d, in sub-tiles of the widest swizzle that divides a row (bf16 rows of
// 32 elements are 64 bytes, of 80 elements 160 bytes, read as five 32-byte
// sub-tiles).  Above 64, f32 runs one consumer warpgroup (64 query rows)
// over 32-row kv tiles; above 64 bf16 runs one block an SM, with up to 64
// registers of o a thread, and its producer warp reads each tile's ids a
// tile ahead, while it waits for the tile's stage.  What holds it there is
// each warpgroup's softmax, about half of a step, under which its own
// tensor-core work stops; overlapping the two within a warpgroup (S of
// tile t and P V of tile t - 1 as two wgmma groups, no producer warp, 255
// registers) was slower on an NVIDIA H100 80GB HBM3 (hb_self_fed).
#pragma once

#include <math.h>

#include <type_traits>

#include "flash_hopper.cuh"

namespace fewbit {
namespace {

// 2^x by the special function unit, denormal results flushed to zero (a
// probability below 2^-126 adds nothing a row's sum can hold).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The block's threads and its ids.  f32: a producer warpgroup (it splits
// and transposes), one block an SM; with two consumer warpgroups setmaxnreg
// 40 / 232, with one each warpgroup keeps what the launch gives (up to 255
// registers).  bf16: the producer only issues TMA and reads ids, so it is
// one warp, and up to head dimension 64 two blocks share an SM (288 threads
// x 112 registers each): one block's prologue, stores and waits run under
// the other's tiles.  AUX: ints of a kv tile's row values, its segment ids
// and for each 32 of them whether they are all one id, and which.
template <typename T, int D>
struct FfShape : HbShape<T, D, FLASH_F1> {
  using Base = HbShape<T, D, FLASH_F1>;
  static constexpr int PRODUCERS = Base::BF16 ? 32 : HB_PRODUCERS;
  static constexpr int THREADS = Base::CONSUMERS + PRODUCERS;
  static constexpr int MIN_BLOCKS = Base::BF16 && D <= 64 ? 2 : 1;
  static constexpr bool REG_SPLIT = !Base::BF16 && Base::WGS == 2;
  static constexpr int AUX = Base::TILE + 4;
};

// map_q: boxes of BLOCK query rows; map_k, map_v: boxes of TILE kv rows,
// read by TMA for bf16 only (f32 copies them with cp.async).
template <typename T, int D>
__global__ void __launch_bounds__(FfShape<T, D>::THREADS,
                                  FfShape<T, D>::MIN_BLOCKS)
    flash_forward_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         FlashParams p) {
  using namespace hopper;
  using S = FfShape<T, D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + S::PARTS * S::RES_BYTES;
  uint8_t* staging = ring + S::STAGES * S::STAGE_BYTES;
  int* aux = reinterpret_cast<int*>(staging +
                                    (S::BF16 ? 0 : 2 * S::TILE_BYTES));
  uint64_t* full = reinterpret_cast<uint64_t*>(aux + S::STAGES * S::AUX);
  uint64_t* empty = full + S::STAGES;
  uint64_t* qbar = empty + S::STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // Under the causal mask the last query blocks have the most tiles: those
  // of every head start first.
  const int row0 = (gridDim.y - 1 - blockIdx.y) * S::BLOCK;
  int t1 = (p.sk + S::TILE - 1) / S::TILE;
  if (p.causal) t1 = min(t1, (min(row0 + S::BLOCK, p.sq) - 1) / S::TILE + 1);

  if (tid == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], S::PRODUCERS);
      mbar_init(&empty[i], S::CONSUMERS);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ----------------------------------------------------------------------
    // The producer warpgroup.
    // ----------------------------------------------------------------------
    if constexpr (S::REG_SPLIT) reg_dealloc<40>();
    const int ptid = tid - S::CONSUMERS;
    if (ptid == 0) {
      mbar_arrive_expect_tx(qbar, S::RES_BYTES);
#pragma unroll
      for (int sub = 0; sub < S::SUB; ++sub)
        tma_load_4d(qs + sub * S::RES_SUB_BYTES, &map_q, qbar,
                    sub * (S::RB / S::ELT), row0, hi, bi);
    }
    const float* kf = static_cast<const float*>(p.k) + bi * p.st_k.b +
                      hi * p.st_k.h;
    const float* vf = static_cast<const float*>(p.v) + bi * p.st_v.b +
                      hi * p.st_v.h;
    // bf16 above 64: the producer warp reads a tile's ids while it waits
    // for the tile's stage, a tile ahead (ahead: its lane's row of each
    // half of 32).  Read after the wait, as below 64, they took a tile as
    // long as a consumer's step at d = 80, and the consumers waited for it.
    constexpr bool AHEAD = S::BF16 && D > 64;
    int ahead[S::TILE / 32];
    auto read_ahead = [&](int t) {
      if (p.seg_kv == nullptr || t >= t1) return;
#pragma unroll
      for (int half = 0; half < S::TILE / 32; ++half) {
        const int row = t * S::TILE + 32 * half + ptid;
        ahead[half] = row < p.sk ? p.seg_kv[(long long)bi * p.sk + row] : 0;
      }
    };
    if constexpr (AHEAD) read_ahead(0);
    int st = 0;
    uint32_t ph = 0;
    for (int t = 0; t < t1; ++t) {
      const int l0 = t * S::TILE;
      mbar_wait(&empty[st], ph ^ 1);
      uint8_t* stage = ring + st * S::STAGE_BYTES;
      // The tile's copies are started first, so that they fly while the ids
      // below are read.
      if constexpr (S::BF16) {
        if (ptid == 0) {
          mbar_expect_tx(&full[st], S::STAGE_BYTES);
#pragma unroll
          for (int sub = 0; sub < S::SUB; ++sub) {
            const int c0 = sub * (S::RB / S::ELT);
            tma_load_4d(stage + sub * S::TILE_SUB_BYTES, &map_k, &full[st],
                        c0, l0, hi, bi);
            tma_load_4d(stage + S::TILE_BYTES + sub * S::TILE_SUB_BYTES,
                        &map_v, &full[st], c0, l0, hi, bi);
          }
        }
      } else {
        fetch_tile<S::TILE, D, S::RB>(stage, kf, p.st_k.s, l0, p.sk, ptid);
        fetch_tile<S::TILE, D, S::RB>(staging, vf, p.st_v.s, l0, p.sk, ptid);
      }
      if (AHEAD && p.seg_kv != nullptr) {
        int* ids = aux + st * S::AUX;
#pragma unroll
        for (int half = 0; half < S::TILE / 32; ++half) {
          const int id = ahead[half];
          ids[32 * half + ptid] = id;
          const int first = __shfl_sync(0xffffffffu, id, 0);
          const int same = __all_sync(0xffffffffu, id == first);
          if (ptid == 0) {
            ids[S::TILE + 2 * half] = same;
            ids[S::TILE + 2 * half + 1] = first;
          }
        }
      } else if (p.seg_kv != nullptr) {
        // The tile's ids in halves of 32, a warp each (one warp all, for
        // bf16): one id in all of a half's?
        int* ids = aux + st * S::AUX;
        for (int half = ptid / 32; half < S::TILE / 32;
             half += S::PRODUCERS / 32) {
          const int r = 32 * half + ptid % 32, row = l0 + r;
          const int id =
              row < p.sk ? p.seg_kv[(long long)bi * p.sk + row] : 0;
          ids[r] = id;
          const int first = __shfl_sync(0xffffffffu, id, 0);
          const int same = __all_sync(0xffffffffu, id == first);
          if (ptid % 32 == 0) {
            ids[S::TILE + 2 * half] = same;
            ids[S::TILE + 2 * half + 1] = first;
          }
        }
      }
      if constexpr (S::BF16) {
        mbar_arrive(&full[st]);
        if constexpr (AHEAD) read_ahead(t + 1);
      } else {
        asm volatile("cp.async.wait_all;" ::: "memory");
        split_fetched<S::TILE, D, S::RB>(stage, ptid);
        split_fetched<S::TILE, D, S::RB>(staging, ptid);
        // Every warp's V chunks are split before any warp transposes them.
        bar_sync(1, HB_PRODUCERS);
        transpose_planes<S::TILE, D, S::RB>(stage + 2 * S::TILE_BYTES,
                                            staging, ptid);
        fence_proxy_async();  // the stores, before wgmma reads them
        mbar_arrive(&full[st]);
        // No warp copies the next tile's V into the staging planes while a
        // slower one still transposes them.
        bar_sync(1, HB_PRODUCERS);
      }
      if (++st == S::STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------------------
    // The consumer warpgroups.
    // ----------------------------------------------------------------------
    if constexpr (S::REG_SPLIT) reg_alloc<232>();
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int rloc = 64 * wg + 16 * warp + g;  // the thread's rows: +0, +8
    const int wrow0 = row0 + 64 * wg;
    int rid[2] = {0, 0};
    if (p.seg_q != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + rloc + 8 * h;
        if (row < p.sq) rid[h] = p.seg_q[(long long)bi * p.sq + row];
      }
    }
    const float scale_log2 = p.scale * LOG2E;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // The running max of each row in the units of S, and the thread's part
    // of the row's sum.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(qs);
    mbar_wait(qbar, 0);

    // f32: the warpgroup's 64 Q rows split once, in place, into TF32 hi
    // (where Q lies) and lo (one Q on) planes: A from shared memory, no
    // fragment registers held over the loop.  The split is elementwise, so
    // the rows' bytes are taken in order, whatever their swizzle.
    if constexpr (!S::BF16) {
      const int wtid = tid % 128;
      constexpr int PER_SUB = 64 * S::RB / 16;  // a warpgroup's, a sub-tile
#pragma unroll
      for (int it = 0; it < D / 8; ++it) {
        const int chunk = wtid + 128 * it;  // of SUB sub-tiles x PER_SUB
        const int off = (chunk >> ilog2(PER_SUB)) * S::RES_SUB_BYTES +
                        wg * 64 * S::RB + (chunk & (PER_SUB - 1)) * 16;
        const float4 v = *reinterpret_cast<const float4*>(qs + off);
        uint4 qhi, qlo;
        split_tf32(v.x, qhi.x, qlo.x);
        split_tf32(v.y, qhi.y, qlo.y);
        split_tf32(v.z, qhi.z, qlo.z);
        split_tf32(v.w, qhi.w, qlo.w);
        *reinterpret_cast<uint4*>(qs + off) = qhi;
        *reinterpret_cast<uint4*>(qs + S::RES_BYTES + off) = qlo;
      }
      fence_proxy_async();  // the stores, before wgmma reads them
      bar_sync(2 + wg, 128);
    }

    // S = Q K^T over d for the tile in the stage at b_addr, issued (x is
    // the warpgroup's accumulator).
    float x[S::TILE / 2];  // S, then P
    const uint32_t a_addr = q_addr + wg * 64 * S::RB;
    auto issue_s = [&](uint32_t b_addr) {
#pragma unroll
      for (int ks = 0; ks < S::KD; ++ks) {
        const uint32_t a = a_addr + (ks / S::KSUB) * S::RES_SUB_BYTES +
                           32 * (ks % S::KSUB);
        const uint32_t b = b_addr + (ks / S::KSUB) * S::TILE_SUB_BYTES +
                           32 * (ks % S::KSUB);
        if constexpr (S::BF16) {
          Wgmma<S::TILE>::bf16_ss(x, desc_sw(a, S::RB), desc_sw(b, S::RB),
                                  ks != 0);
        } else {
          const uint64_t ah = desc_sw(a, S::RB);
          const uint64_t al = desc_sw(a + S::RES_BYTES, S::RB);
          const uint64_t bh = desc_sw(b, S::RB);
          const uint64_t bl = desc_sw(b + S::TILE_BYTES, S::RB);
          Wgmma<S::TILE>::tf32_ss(x, ah, bh, ks != 0);
          Wgmma<S::TILE>::tf32_ss(x, ah, bl);
          Wgmma<S::TILE>::tf32_ss(x, al, bh);
        }
      }
      wgmma_commit();
    };

    // The online softmax of the tile at l0 (its ids in stage st's row
    // values): x = P, m and l updated, alpha the factor of o.
    auto softmax = [&](int st, int l0, float (&alpha)[2]) {
      // Segment ids need no compare where the tile has one id and all of
      // this warp's rows have it too (one document, or no padding here).
      const int* ax = aux + st * S::AUX;
      bool by_segment = p.seg_q != nullptr;
      if (by_segment) by_segment = !one_segment<S::TILE>(ax + S::TILE, rid);
      const bool diagonal = p.causal && l0 + S::TILE - 1 > wrow0;
      // The unmasked path takes the max of the raw products: a scale that
      // is not positive takes the masked one.
      const bool masked = by_segment || diagonal || l0 + S::TILE > p.sk ||
                          !(p.scale > 0.f);
      float mx[2] = {m[0], m[1]};
      auto run = [&](auto masked_c) {
        constexpr bool MASKED = decltype(masked_c)::value;
        if (MASKED) {
          // x = the masked logit (-inf past the sequence), then its max.
#pragma unroll
          for (int i = 0; i < S::TILE / 8; ++i) {
            const int col = 8 * i + 2 * tq;
            const int2 id2 = by_segment
                                 ? *reinterpret_cast<const int2*>(ax + col)
                                 : make_int2(0, 0);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * i + 2 * h + e;
                const int rowg = row0 + rloc + 8 * h, colg = l0 + col + e;
                bool keep = !by_segment || rid[h] == (e ? id2.y : id2.x);
                if (p.causal) keep = keep && colg <= rowg;
                float val = x[idx] * p.scale;
                if (!keep) val += MASK_VALUE;
                x[idx] = colg < p.sk ? val : -INFINITY;
                mx[h] = fmaxf(mx[h], x[idx]);
              }
          }
        } else {
          float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int idx = 0; idx < S::TILE / 2; ++idx)
            raw[(idx >> 1) & 1] = fmaxf(raw[(idx >> 1) & 1], x[idx]);
          mx[0] = fmaxf(mx[0], raw[0] * p.scale);
          mx[1] = fmaxf(mx[1], raw[1] * p.scale);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        // The running max moves only where some row of the warp gains more
        // than 2^8 on it: P then stays at most 2^8 (no overflow in f32 or
        // bf16, the same relative rounding), o and l need no rescale, and
        // lse = m + log(l) holds for whatever m was kept.  The first tile
        // moves it (from -inf), as does a real logit after masked ones
        // (from the mask value).
        const bool stay = __all_sync(
            0xffffffffu, (mx[0] - m[0]) * LOG2E <= 8.f &&
                             (mx[1] - m[1]) * LOG2E <= 8.f);
        float mlog2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // Every tile holds a key below sk, so the new max is finite; the
          // first tile's alpha is exp2(-inf) = 0.
          alpha[h] = stay ? 1.f : fast_exp2((m[h] - mx[h]) * LOG2E);
          if (!stay) m[h] = mx[h];
          mlog2[h] = m[h] * LOG2E;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int idx = 0; idx < S::TILE / 2; ++idx) {
          const int h = (idx >> 1) & 1;
          // Masked: the difference first, in the units of S, then log2 e.
          const float pv =
              MASKED ? fast_exp2((x[idx] - m[h]) * LOG2E)
                     : fast_exp2(fmaf(x[idx], scale_log2, -mlog2[h]));
          x[idx] = pv;
          l[h] += pv;
        }
      };
      if (masked)
        run(std::true_type{});
      else
        run(std::false_type{});
    };
    auto rescale = [&](const float (&alpha)[2]) {
      if (alpha[0] == 1.f && alpha[1] == 1.f) return;
#pragma unroll
      for (int idx = 0; idx < D / 2; ++idx) o[idx] *= alpha[(idx >> 1) & 1];
    };

    // Under the causal mask the tiles from t_end on lie wholly past this
    // warpgroup's rows and add nothing to them: it only frees their stages.
    const int t_end =
        p.causal ? min(t1, (wrow0 + 63) / S::TILE + 1) : t1;
    int st = 0;
    uint32_t ph = 0;
    auto advance = [&] {
      if (++st == S::STAGES) {
        st = 0;
        ph ^= 1;
      }
    };
    for (int t = 0; t < t_end; ++t) {
      mbar_wait(&full[st], ph);
      __syncwarp();  // wgmma is .aligned: the warp converges first
      const uint32_t b_addr = smem_u32(ring + st * S::STAGE_BYTES);
      fence_operands(x);
      wgmma_fence();
      issue_s(b_addr);
      wgmma_wait<0>();
      fence_operands(x);
      float alpha[2];
      softmax(st, t * S::TILE, alpha);
      rescale(alpha);
      // O += P V over the tile's rows, P from registers.
      if constexpr (S::BF16) {
        uint32_t px[S::KT][4];  // P packed into the m64k16 A fragments
#pragma unroll
        for (int j = 0; j < S::KT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            px[j][r] = pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
        fence_operands(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < S::KT; ++j)
          // V MN-major: step j is its rows 16 j .. 16 j + 15.
          Wgmma<D>::template bf16_rs<1>(
              o, px[j],
              desc_sw(b_addr + S::TILE_BYTES + 16 * S::RB * j, S::RB,
                      S::MN_LBO));
        wgmma_commit();
        wgmma_wait<0>();
        keep_alive(px);
        fence_operands(o);
      } else {
        tf32_rows_product<D, S::TILE>(o, x, b_addr + 2 * S::TILE_BYTES);
      }
      mbar_arrive(&empty[st]);
      advance();
    }
    for (int t = t_end; t < t1; ++t) {
      mbar_wait(&full[st], ph);
      mbar_arrive(&empty[st]);
      advance();
    }

    T* out = static_cast<T*>(p.o) + bi * p.st_o.b + hi * p.st_o.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + rloc + 8 * h;
      if (row >= p.sq) continue;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int idx = 4 * i + 2 * h, col = 8 * i + 2 * tq;
        store2(out + (long long)row * p.st_o.s + col, o[idx] * inv,
               o[idx + 1] * inv);
      }
      if (tq == 0) p.lse_out[(long long)bh * p.sq + row] = m[h] + logf(l[h]);
    }
  }
}

// Launches F1 at head dimension D.  Returns as the entry point does.
template <typename T, int D>
int launch_forward(const FlashParams& p, int b, cudaStream_t st) {
  using S = FfShape<T, D>;
  if (b <= 0 || p.h <= 0 || p.sq <= 0 || p.sk <= 0) return -1;
  // K's and V's maps are read for bf16 only (f32 copies them with cp.async).
  CUtensorMap mq, mk = {}, mv = {};
  const bool ok =
      operand_map<T>(&mq, p.q, p.st_q, b, p.h, p.sq, D, S::BLOCK, S::RB) &&
      (!S::BF16 ||
       (operand_map<T>(&mk, p.k, p.st_k, b, p.h, p.sk, D, S::TILE, S::RB) &&
        operand_map<T>(&mv, p.v, p.st_v, b, p.h, p.sk, D, S::TILE, S::RB)));
  if (!ok) return -2;
  auto kernel = flash_forward_kernel<T, D>;
  constexpr int smem = ff_smem(S::BF16, D);
  static_assert(smem <= HB_SMEM_LIMIT, "the block's shared memory");
  static unsigned allowed = 0;
  if (const int err = allow_smem(kernel, smem, allowed)) return err;
  kernel<<<dim3(b * p.h, (p.sq + S::BLOCK - 1) / S::BLOCK), S::THREADS, smem,
           st>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit

// Defines fewbit::flash_forward_d<D>, the launcher of both types at D.
#define FEWBIT_FLASH_FORWARD_D(D)                                          \
  namespace fewbit {                                                      \
  int flash_forward_d##D(const FlashParams& p, int b, bool bf16,          \
                         cudaStream_t st) {                                \
    return bf16 ? launch_forward<__nv_bfloat16, D>(p, b, st)              \
                : launch_forward<float, D>(p, b, st);                      \
  }                                                                        \
  }
