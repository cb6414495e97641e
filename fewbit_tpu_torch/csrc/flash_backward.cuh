// Flash attention's backward on the tensor cores: the dK/dV kernel (F2) and
// the dQ kernel (F3), each every product a wgmma.  The kernel and its
// launcher, templated on the head dimension; flash_backward*.cu instantiate
// them at every multiple of 16 up to 128, and flash_backward.cu holds the
// entry points.
//
// Replaces JAX's Pallas TPU library kernels _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/
// flash_attention.py).  With S = sm_scale Q K^T (scaled after the product),
// DEFAULT_MASK_VALUE added where the causal or segment mask is false,
// P = exp(S - lse), dP = dO V^T and dS = P (dP - di) sm_scale: F2 gives
// dV = P^T dO and dK = dS^T Q per kv block, F3 gives dQ = dS K per query
// block.  lse is the forward's, di = sum(dO * O) the caller's.
//
// What bounds it on this card: at GPT-2 small (8 x 12 heads, seq 1024,
// causal) F2 is 4 and F3 3 products of 2 * 64 operations on each of the
// 50.4 M unmasked pairs: 25.8 and 19.4 GFLOP against about 130 MB of f32
// operands.  The tensor cores bound both: 0.026 and 0.020 ms in bf16 at 989
// TFLOP/s, 0.156 and 0.117 ms in f32 as three TF32 products at 495 TFLOP/s.
//
// Design (one kernel template; DKV selects F2 or F3; the shapes below are
// those of head dimension 64, and hb_tiles gives the others'):
// - A block owns 128 rows of its own side (kv rows in F2, query rows in F3),
//   64 per consumer warpgroup, and loops over 64-row tiles of the other
//   side itself, from the diagonal on (F2) or up to it (F3) under the causal
//   mask.  Nothing is summed across blocks: no atomics, and both gradients
//   are bitwise repeatable.  Blocks with the most tiles are scheduled first.
// - The first two products contract over d, so every operand is K-major as
//   it lies in memory: F2 computes S^T = K Q^T and dP^T = V dO^T, F3
//   S = Q K^T and dP = dO V^T, with the block's own rows (loaded once, by
//   TMA, through a 4-D map over the tensor's own strides) as the A operand
//   and the looped tile as B.
// - P and dS never go through shared memory: the accumulator fragment of
//   the first product is the A operand of the second from registers (P^T
//   and dS^T in F2, dS in F3).  bf16 packs neighbouring columns into the
//   m64k16 fragment.  For tf32 the m64k8 fragment wants columns t and t + 4
//   where the accumulator holds 2 t and 2 t + 1; that fixed permutation of
//   the eight k indices of a step is carried by the B tile instead.
// - The second products contract over the looped rows, so their B operand
//   (dO and Q in F2, K in F3) is MN-major in memory.  bf16 wgmma reads that
//   through its transpose bit: one tile, loaded by TMA into a ring of four
//   stages, serves both products.  tf32 wgmma takes K-major operands only,
//   and 3xTF32 (hi hi + hi lo + lo hi) wants B as TF32 hi and lo planes: for
//   f32 the producer warpgroup copies the tile raw with cp.async (16 bytes a
//   chunk, straight to where the lo plane will lie, so no register waits on
//   a load), splits each chunk in place into the K-major planes of the first
//   products, and then copies those planes, transposed and k-permuted, into
//   the planes of the second products.  TMA could do neither the split nor
//   the permutation, and a raw copy beside the eight planes of a tile would
//   not fit; the planes take 128 KB (F2) or 96 KB (F3) beside the block's
//   own 64 KB, so f32 runs a single stage, handed over in two halves (the
//   first products' planes, then the second's), each filled while the
//   consumers work on the other.
// - The producer warpgroup gives registers to the two consumer warpgroups
//   (setmaxnreg 40 / 232: together the block's 384 x 168 of the launch; a
//   wait for more than that never ends; bf16 F2 above 64 runs without it,
//   below).  F2 holds dK, dV, S^T and dP^T (128 registers) beside the A
//   fragments of a product, so in f32 it takes the first products one k
//   step at a time (the next step's fragments loaded and split while this
//   one multiplies) and the second products one after the other.
// - Between the products: exp2 on logits scaled by log2 e, the mask (only
//   on diagonal, ragged and segment-id tiles), lse and di of the looped tile
//   from shared memory (F2: by column) or registers (F3: by row); sm_scale
//   multiplies dK and dQ once, at the store.
// What holds it (NVIDIA H100 80GB HBM3 at 700 W, GPT shape, device time):
// f32 reaches about a third of its bound: of a tile's time the two
// warpgroups' wgmma fill less than half, the rest is the handover of the
// single stage and the fragments' splits.  bf16 reaches about a quarter: a
// block's prologue and stores are not overlapped with another block's tiles
// (one block per SM), and both warpgroups run the exp at the same time.
// Other head dimensions: the same kernel with its planes and products over
// d, in sub-tiles of the widest swizzle that divides a row (bf16 rows of
// 32 elements are 64 bytes, read with the 64-byte swizzle; of 80 elements
// five 32-byte sub-tiles).  Above 64, f32 runs one consumer warpgroup (64
// own rows, up to 255 registers a thread) over 32-row tiles.  bf16 keeps
// the shape of 64 (two warpgroups, 128 own rows, 64-row tiles, four
// stages): F3 as it is; F2, whose warpgroups hold dK and dV (d registers)
// beside S^T, dP^T and their packed fragments (208 to 254 registers at 80
// to 128), runs no producer warpgroup (hb_self_fed): 256 threads, 255
// registers, a consumer warp issuing the TMA loads and copying the row
// values by cp.async.  At Cerebras-GPT-590M's (2, 12, 2048, 128) causal
// that took bf16 F2 from 0.19 to 0.13 ms (28% to 41% of its bound), at
// Cerebras-GPT-2.7B's (1, 32, 2048, 80) from 0.25 to 0.14 (18% to 31%);
// the wide backward's schedule at one chunk (two warpgroups sharing 64 own
// rows, P through shared memory) reached 0.17 and 0.20.  There both take
// exp2 from the SFU alone (ex2.approx.ftz): F2 3 to 5% faster for it, F3
// 6 to 9%.
#pragma once

#include <math.h>

#include <type_traits>

#include "flash_hopper.cuh"

namespace fewbit {
namespace {

// The buffers of per-tile row values (AUX words each: lse, di and segment
// ids, and for each 32 ids whether they are all one id, and which), whether
// the block runs without a producer warpgroup (SELF: bf16 F2 above 64,
// whose dK and dV and their operands need more than the 168 registers a
// thread of a 384-thread block may have), the block's threads, and whether
// its consumers take registers from the producer (setmaxnreg 40 / 232,
// with two consumer warpgroups; else they keep what the launch gives, up
// to 255).
template <typename T, int D, bool DKV>
struct HbBwdShape : HbShape<T, D, DKV ? FLASH_F2 : FLASH_F3> {
  using Base = HbShape<T, D, DKV ? FLASH_F2 : FLASH_F3>;
  static constexpr int NAUX = Base::BF16 ? Base::STAGES : 2;
  static constexpr int AUX = 3 * Base::TILE + 4;
  static constexpr bool SELF =
      hb_self_fed(DKV ? FLASH_F2 : FLASH_F3, Base::BF16, D);
  static constexpr int THREADS = Base::CONSUMERS + (SELF ? 0 : HB_PRODUCERS);
  static constexpr bool REG_SPLIT = Base::WGS == 2 && !SELF;
};

// F2 (DKV) or F3.  map_r1, map_r2: the block's own operands (K and V in F2,
// Q and dO in F3), boxes of BLOCK rows; map_l1, map_l2: the looped ones (Q
// and dO in F2, K and V in F3), boxes of TILE rows, read by TMA for bf16
// only.
template <typename T, int D, bool DKV>
__global__ void __launch_bounds__(HbBwdShape<T, D, DKV>::THREADS, 1)
    flash_backward_kernel(const __grid_constant__ CUtensorMap map_r1,
                          const __grid_constant__ CUtensorMap map_r2,
                          const __grid_constant__ CUtensorMap map_l1,
                          const __grid_constant__ CUtensorMap map_l2,
                          FlashParams p) {
  using namespace hopper;
  using S = HbBwdShape<T, D, DKV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* part1 = res + 2 * S::RES_BYTES;
  uint8_t* part2 = part1 + S::STAGES * S::STAGE_BYTES;
  float* aux = reinterpret_cast<float*>(
      part2 + (S::BF16 ? 0 : (DKV ? 2 : 1) * 2 * S::TILE_BYTES));
  uint64_t* full1 = reinterpret_cast<uint64_t*>(aux + S::NAUX * S::AUX);
  uint64_t* empty1 = full1 + S::STAGES;
  uint64_t* full2 = empty1 + S::STAGES;
  uint64_t* empty2 = full2 + 1;
  uint64_t* resb = empty2 + 1;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // Under the causal mask the first kv blocks and the last query blocks
  // have the most tiles: those of every head start first.
  const int blk = DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  const int row0 = blk * S::BLOCK;
  const int n_res = DKV ? p.sk : p.sq, n_loop = DKV ? p.sq : p.sk;
  int t0 = 0, t1 = (n_loop + S::TILE - 1) / S::TILE;
  if (p.causal) {
    if (DKV)
      t0 = row0 / S::TILE;
    else
      t1 = min(t1, (min(row0 + S::BLOCK, p.sq) - 1) / S::TILE + 1);
  }
  const int* seg_loop = DKV ? p.seg_q : p.seg_kv;
  const int* seg_res = DKV ? p.seg_kv : p.seg_q;
  const float* lse = p.lse_in + (long long)bh * p.sq;
  const float* di = p.di + (long long)bh * p.sq;

  if (tid == 0) {
    // SELF: the issuing warp's 32 cp.async arrivals and its first lane's.
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full1[i], S::SELF ? 33 : HB_PRODUCERS);
      mbar_init(&empty1[i], S::CONSUMERS);
    }
    mbar_init(full2, HB_PRODUCERS);
    mbar_init(empty2, S::CONSUMERS);
    mbar_init(resb, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // By TMA, from one thread: the block's own rows (once), and (bf16) the
  // looped tile from row l0 on into `stage`, their bytes counted on `bar`.
  auto load_own_rows = [&]() {
    mbar_arrive_expect_tx(resb, 2 * S::RES_BYTES);
#pragma unroll
    for (int sub = 0; sub < S::SUB; ++sub) {
      const int c0 = sub * (S::RB / S::ELT);
      tma_load_4d(res + sub * S::RES_SUB_BYTES, &map_r1, resb, c0, row0, hi,
                  bi);
      tma_load_4d(res + S::RES_BYTES + sub * S::RES_SUB_BYTES, &map_r2, resb,
                  c0, row0, hi, bi);
    }
  };
  auto load_tile = [&](uint8_t* stage, uint64_t* bar, int l0) {
#pragma unroll
    for (int sub = 0; sub < S::SUB; ++sub) {
      const int c0 = sub * (S::RB / S::ELT);
      tma_load_4d(stage + sub * S::TILE_SUB_BYTES, &map_l1, bar, c0, l0, hi,
                  bi);
      tma_load_4d(stage + S::TILE_BYTES + sub * S::TILE_SUB_BYTES, &map_l2,
                  bar, c0, l0, hi, bi);
    }
  };

  if (!S::SELF && tid >= S::CONSUMERS) {
    // ----------------------------------------------------------------------
    // The producer warpgroup.
    // ----------------------------------------------------------------------
    if constexpr (S::REG_SPLIT) reg_dealloc<40>();
    const int ptid = tid - S::CONSUMERS;
    if (ptid == 0) load_own_rows();
    const Strides& st1 = DKV ? p.st_q : p.st_k;
    const Strides& st2 = DKV ? p.st_do : p.st_v;
    const T* l1 = static_cast<const T*>(DKV ? p.q : p.k) + bi * st1.b +
                  hi * st1.h;
    const T* l2 = static_cast<const T*>(DKV ? p.dout : p.v) + bi * st2.b +
                  hi * st2.h;
    int st = 0;
    uint32_t ph = 0, ph2 = 0;
    for (int t = t0; t < t1; ++t) {
      const int l0 = t * S::TILE;
      mbar_wait(&empty1[st], ph ^ 1);
      uint8_t* stage = part1 + st * S::STAGE_BYTES;
      const float* f1 = reinterpret_cast<const float*>(l1);
      const float* f2 = reinterpret_cast<const float*>(l2);
      // The tile's copies are started first, so that they fly while the
      // row values below are read.
      if constexpr (S::BF16) {
        if (ptid == 0) {
          mbar_expect_tx(&full1[st], S::STAGE_BYTES);
          load_tile(stage, &full1[st], l0);
        }
      } else {
        fetch_tile<S::TILE, D, S::RB>(stage, f1, st1.s, l0, n_loop, ptid);
        fetch_tile<S::TILE, D, S::RB>(stage + 2 * S::TILE_BYTES, f2, st2.s,
                                      l0, n_loop, ptid);
      }
      if (ptid < S::TILE) {  // the tile's row values
        float* ax = aux + (t % S::NAUX) * S::AUX;
        const int row = l0 + ptid;
        const bool in = row < n_loop;
        if (DKV) {
          ax[ptid] = in ? lse[row] : 0.f;
          ax[S::TILE + ptid] = in ? di[row] : 0.f;
        }
        const int id = seg_loop != nullptr && in
                           ? seg_loop[(long long)bi * n_loop + row]
                           : 0;
        int* ids = reinterpret_cast<int*>(ax) + 2 * S::TILE;
        ids[ptid] = id;
        // The first TILE / 32 warps hold the tile's ids: one id in all of a
        // warp's?
        const int first = __shfl_sync(0xffffffffu, id, 0);
        const int same = __all_sync(0xffffffffu, id == first);
        if (ptid % 32 == 0) {
          ids[S::TILE + 2 * (ptid / 32)] = same;
          ids[S::TILE + 2 * (ptid / 32) + 1] = first;
        }
      }
      if constexpr (S::BF16) {
        mbar_arrive(&full1[st]);
      } else {
        asm volatile("cp.async.wait_all;" ::: "memory");
        split_fetched<S::TILE, D, S::RB>(stage, ptid);
        split_fetched<S::TILE, D, S::RB>(stage + 2 * S::TILE_BYTES, ptid);
        fence_proxy_async();  // the stores, before wgmma reads them
        mbar_arrive(&full1[st]);
        // The second products' planes, from the ones just written (they
        // stay until this warpgroup writes the next tile's).
        bar_sync(1, HB_PRODUCERS);
        mbar_wait(empty2, ph2 ^ 1);
        transpose_planes<S::TILE, D, S::RB>(part2, stage, ptid);
        if (DKV)
          transpose_planes<S::TILE, D, S::RB>(part2 + 2 * S::TILE_BYTES,
                                              stage + 2 * S::TILE_BYTES,
                                              ptid);
        fence_proxy_async();
        mbar_arrive(full2);
        ph2 ^= 1;
        // The consumers freed the first products' planes long ago, so
        // nothing else keeps a warp from copying the next tile over planes
        // that a slower warp is still transposing.
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
    // What the thread's two rows bring: their segment ids and, in F3, lse
    // and di.
    int rid[2] = {0, 0};
    float rlse[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rloc + 8 * h;
      if (row < n_res) {
        if (seg_res != nullptr) rid[h] = seg_res[(long long)bi * n_res + row];
        if (!DKV) {
          rlse[h] = lse[row];
          rdi[h] = di[row];
        }
      }
    }
    const float scale_log2 = p.scale * LOG2E;
    // da: dK (F2) or dQ (F3) without sm_scale; db: dV (F2).
    float da[D / 2], db[DKV ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) da[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKV ? D / 2 : 1); ++i) db[i] = 0.f;
    const uint32_t res_addr = smem_u32(res);

    // SELF: the second warpgroup's first warp issues the loads: the own
    // rows once, then looped tile `it` into stage ist, its operands by TMA
    // from the first lane and its row values by cp.async, two rows a lane,
    // each lane arriving on the stage's full barrier when its copies land
    // (the flags of one_segment are left unwritten: each warp reads the
    // ids).  STAGES tiles go out at first, then one a tile while the warp's
    // second products run, into the stage of the tile before, which the
    // other warpgroup has most likely freed too.
    const bool issuer = S::SELF && wg == 1 && warp == 0;
    int it = t0, ist = 0;
    uint32_t iph = 0;
    auto issue = [&]() {
      if (it >= t1) return;
      const int l0 = it * S::TILE;
      uint8_t* stage = part1 + ist * S::STAGE_BYTES;
      if (lane == 0) {
        mbar_wait(&empty1[ist], iph ^ 1);
        mbar_arrive_expect_tx(&full1[ist], S::STAGE_BYTES);
        load_tile(stage, &full1[ist], l0);
      }
      __syncwarp();  // the stage's row values are free too
      float* ax = aux + (it % S::NAUX) * S::AUX;
#pragma unroll
      for (int r = lane; r < S::TILE; r += 32) {
        const int row = l0 + r;
        const bool in = row < n_loop, has_id = in && seg_loop != nullptr;
        cp_async4(ax + r, lse + (in ? row : 0), in);
        cp_async4(ax + S::TILE + r, di + (in ? row : 0), in);
        cp_async4(ax + 2 * S::TILE + r,
                  has_id ? seg_loop + (long long)bi * n_loop + row
                         : static_cast<const void*>(lse),
                  has_id);
      }
      cp_async_arrive(&full1[ist]);
      ++it;
      if (++ist == S::STAGES) {
        ist = 0;
        iph ^= 1;
      }
    };
    if (issuer) {
      if (lane == 0) load_own_rows();
      for (int n = 0; n < S::STAGES; ++n) issue();
    }
    mbar_wait(resb, 0);

    // f32: the TF32 hi and lo A fragments of the block's own rows for the
    // first products, CH k steps (chunk c) in each of two buffers.  F2 has
    // dK and dV to hold besides, and takes one step at a time.
    constexpr int CH = DKV ? 1 : 2;
    uint32_t fh1[2][CH][4], fl1[2][CH][4], fh2[2][CH][4], fl2[2][CH][4];
    auto load_fragments = [&](int c) {
#pragma unroll
      for (int q = 0; q < CH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ks = CH * c + q;
          const uint32_t off =
              (ks / S::KSUB) * S::RES_SUB_BYTES +
              swizzled_offset(rloc + 8 * (e & 1),
                              8 * (ks % S::KSUB) + tq + 4 * (e >> 1), 4,
                              S::RB);
          split_tf32(*reinterpret_cast<const float*>(res + off),
                     fh1[c & 1][q][e], fl1[c & 1][q][e]);
          split_tf32(
              *reinterpret_cast<const float*>(res + S::RES_BYTES + off),
              fh2[c & 1][q][e], fl2[c & 1][q][e]);
        }
    };

    int st = 0;
    uint32_t ph = 0, ph2 = 0;
    for (int t = t0; t < t1; ++t) {
      const int l0 = t * S::TILE;
      // S and dP (F2: transposed), then P and dS.
      float x[S::TILE / 2], y[S::TILE / 2];
      if constexpr (!S::BF16) load_fragments(0);
      mbar_wait(&full1[st], ph);
      __syncwarp();  // wgmma is .aligned: the warp converges first
      const uint32_t b_addr = smem_u32(part1 + st * S::STAGE_BYTES);

      // -- The first products: x = R1 L1^T, y = R2 L2^T over d. ----------
      if constexpr (S::BF16) {
        const uint32_t a1 = res_addr + wg * 64 * S::RB;
        fence_operands(x);
        fence_operands(y);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < S::KD; ++ks) {
          const uint32_t a = a1 + (ks / S::KSUB) * S::RES_SUB_BYTES +
                             32 * (ks % S::KSUB);
          const uint32_t b = b_addr + (ks / S::KSUB) * S::TILE_SUB_BYTES +
                             32 * (ks % S::KSUB);
          Wgmma<S::TILE>::bf16_ss(x, desc_sw(a, S::RB), desc_sw(b, S::RB),
                                  ks != 0);
          Wgmma<S::TILE>::bf16_ss(y, desc_sw(a + S::RES_BYTES, S::RB),
                                  desc_sw(b + S::TILE_BYTES, S::RB), ks != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(x);
        fence_operands(y);
      } else {
        // CH k steps at a time.  While one chunk multiplies, the next
        // chunk's A fragments are loaded and split into registers of their
        // own (the first chunk's: before the tile had arrived).
#pragma unroll
        for (int c = 0; c < S::KD / CH; ++c) {
          constexpr int LAST = S::KD / CH - 1;
          const int cur = c & 1;
          fence_operands(x);
          fence_operands(y);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < CH; ++q) {
            const int ks = CH * c + q;
            const uint32_t b = b_addr + (ks / S::KSUB) * S::TILE_SUB_BYTES +
                               32 * (ks % S::KSUB);
            const uint64_t b1h = desc_sw(b, S::RB);
            const uint64_t b1l = desc_sw(b + S::TILE_BYTES, S::RB);
            const uint64_t b2h = desc_sw(b + 2 * S::TILE_BYTES, S::RB);
            const uint64_t b2l = desc_sw(b + 3 * S::TILE_BYTES, S::RB);
            Wgmma<S::TILE>::tf32_rs(x, fh1[cur][q], b1h, ks != 0);
            Wgmma<S::TILE>::tf32_rs(x, fh1[cur][q], b1l);
            Wgmma<S::TILE>::tf32_rs(x, fl1[cur][q], b1h);
            Wgmma<S::TILE>::tf32_rs(y, fh2[cur][q], b2h, ks != 0);
            Wgmma<S::TILE>::tf32_rs(y, fh2[cur][q], b2l);
            Wgmma<S::TILE>::tf32_rs(y, fl2[cur][q], b2h);
          }
          wgmma_commit();
          if (c < LAST) load_fragments(c + 1);
          wgmma_wait<0>();
          keep_alive(fh1[cur]);
          keep_alive(fl1[cur]);
          keep_alive(fh2[cur]);
          keep_alive(fl2[cur]);
        }
        fence_operands(x);
        fence_operands(y);
        mbar_arrive(&empty1[st]);  // the first products' planes are free
      }
      // -- Between the products: x = P, y = dS. --------------------------
      // The fragment's rows are the block's own side, its columns the
      // looped tile's: F2 rows are keys c and columns queries r, F3 the
      // other way round.
      const float* ax = aux + (t % S::NAUX) * S::AUX;
      const int wrow0 = row0 + 64 * wg;
      const bool diagonal =
          p.causal && (DKV ? wrow0 + 63 > l0 : l0 + S::TILE - 1 > wrow0);
      // Segment ids need no compare where the tile has one id and all of
      // this warp's rows have it too (one document, or no padding here).
      bool by_segment = seg_loop != nullptr;
      if (by_segment)
        by_segment =
            S::SELF ? !one_segment_read<S::TILE>(
                          reinterpret_cast<const int*>(ax) + 2 * S::TILE, rid)
                    : !one_segment<S::TILE>(
                          reinterpret_cast<const int*>(ax) + 3 * S::TILE, rid);
      const bool masked = by_segment || diagonal || l0 + S::TILE > n_loop;
      // exp2: the SFU's alone in bf16 above 64.
      auto pow2 = [](float v) {
        return S::BF16 && D > 64 ? ex2(v) : exp2f(v);
      };
      auto between = [&](auto masked_c) {
        constexpr bool MASKED = decltype(masked_c)::value;
#pragma unroll
        for (int i = 0; i < S::TILE / 8; ++i) {
          const int col = 8 * i + 2 * tq;
          float2 lse2 = make_float2(0.f, 0.f), di2 = lse2;
          int2 id2 = make_int2(0, 0);
          if (DKV) {
            lse2 = *reinterpret_cast<const float2*>(ax + col);
            di2 = *reinterpret_cast<const float2*>(ax + S::TILE + col);
          }
          if (MASKED)
            id2 = *reinterpret_cast<const int2*>(
                reinterpret_cast<const int*>(ax) + 2 * S::TILE + col);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * i + 2 * h + e;
              const int rowg = row0 + rloc + 8 * h, colg = l0 + col + e;
              const float lse_v = DKV ? (e ? lse2.y : lse2.x) : rlse[h];
              const float di_v = DKV ? (e ? di2.y : di2.x) : rdi[h];
              float pv;
              if (MASKED) {
                const int r = DKV ? colg : rowg, c = DKV ? rowg : colg;
                bool keep = !by_segment || rid[h] == (e ? id2.y : id2.x);
                if (p.causal) keep = keep && c <= r;
                float val = x[idx] * p.scale;
                if (!keep) val += MASK_VALUE;
                // A looped row past the sequence takes no part.
                pv = colg < n_loop ? pow2((val - lse_v) * LOG2E) : 0.f;
              } else {
                pv = pow2(fmaf(x[idx], scale_log2, -LOG2E * lse_v));
              }
              x[idx] = pv;
              y[idx] = pv * (y[idx] - di_v);  // sm_scale: at the store
            }
        }
      };
      if (masked)
        between(std::true_type{});
      else
        between(std::false_type{});
      // -- The second products: da += y L1, db += x L2 over the tile's
      // rows, x and y from registers. ------------------------------------
      if constexpr (S::BF16) {
        uint32_t px[S::KT][4], py[S::KT][4];
#pragma unroll
        for (int j = 0; j < S::KT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (DKV)
              px[j][r] = pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
            py[j][r] = pack_bf16(y[8 * j + 2 * r], y[8 * j + 2 * r + 1]);
          }
        fence_operands(da);
        fence_operands(db);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < S::KT; ++j) {
          // The tile MN-major: step j is its rows 16 j .. 16 j + 15.
          const uint32_t off = 16 * S::RB * j;
          if constexpr (DKV)
            Wgmma<D>::template bf16_rs<1>(
                db, px[j],
                desc_sw(b_addr + S::TILE_BYTES + off, S::RB, S::MN_LBO));
          Wgmma<D>::template bf16_rs<1>(
              da, py[j], desc_sw(b_addr + off, S::RB, S::MN_LBO));
        }
        wgmma_commit();
        // The next load goes out while the products run.
        if (issuer && t > t0) issue();
        wgmma_wait<0>();
        if (DKV) keep_alive(px);
        keep_alive(py);
        fence_operands(da);
        fence_operands(db);
        mbar_arrive(&empty1[st]);
      } else {
        mbar_wait(full2, ph2);
        __syncwarp();
        // One product at a time: its 64 fragment registers are free again
        // before the next one's are made.
        if constexpr (DKV)
          tf32_rows_product<D, S::TILE>(db, x,
                                        smem_u32(part2) + 2 * S::TILE_BYTES);
        tf32_rows_product<D, S::TILE>(da, y, smem_u32(part2));
        mbar_arrive(empty2);
        ph2 ^= 1;
      }
      if (++st == S::STAGES) {
        st = 0;
        ph ^= 1;
      }
    }

    const Strides& sta = DKV ? p.st_dk : p.st_dq;
    T* out_a = static_cast<T*>(DKV ? p.dk : p.dq) + bi * sta.b + hi * sta.h;
    T* out_b = static_cast<T*>(p.dv) + bi * p.st_dv.b + hi * p.st_dv.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rloc + 8 * h;
      if (row >= n_res) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int idx = 4 * i + 2 * h, col = 8 * i + 2 * tq;
        store2(out_a + (long long)row * sta.s + col, da[idx] * p.scale,
               da[idx + 1] * p.scale);
        if constexpr (DKV)
          store2(out_b + (long long)row * p.st_dv.s + col, db[idx],
                 db[idx + 1]);
      }
    }
  }
}

// Launches F2 (DKV) or F3 at head dimension D.  Returns as the entry
// points do.
template <typename T, int D, bool DKV>
int launch_backward(const FlashParams& p, int b, cudaStream_t st) {
  using S = HbBwdShape<T, D, DKV>;
  if (b <= 0 || p.h <= 0 || p.sq <= 0 || p.sk <= 0) return -1;
  // The looped operands' maps are read for bf16 only (f32 loads them with
  // cp.async).
  CUtensorMap r1, r2, l1 = {}, l2 = {};
  const int own = DKV ? p.sk : p.sq, loop = DKV ? p.sq : p.sk;
  const void* own1 = DKV ? p.k : p.q;
  const void* own2 = DKV ? p.v : p.dout;
  const void* loop1 = DKV ? p.q : p.k;
  const void* loop2 = DKV ? p.dout : p.v;
  const Strides& so1 = DKV ? p.st_k : p.st_q;
  const Strides& so2 = DKV ? p.st_v : p.st_do;
  const Strides& sl1 = DKV ? p.st_q : p.st_k;
  const Strides& sl2 = DKV ? p.st_do : p.st_v;
  const bool ok =
      operand_map<T>(&r1, own1, so1, b, p.h, own, D, S::BLOCK, S::RB) &&
      operand_map<T>(&r2, own2, so2, b, p.h, own, D, S::BLOCK, S::RB) &&
      (!S::BF16 ||
       (operand_map<T>(&l1, loop1, sl1, b, p.h, loop, D, S::TILE, S::RB) &&
        operand_map<T>(&l2, loop2, sl2, b, p.h, loop, D, S::TILE, S::RB)));
  if (!ok) return -2;
  auto kernel = flash_backward_kernel<T, D, DKV>;
  constexpr int smem = hb_smem(S::BF16, DKV, D);
  static_assert(smem <= HB_SMEM_LIMIT, "the block's shared memory");
  static unsigned allowed = 0;
  if (const int err = allow_smem(kernel, smem, allowed)) return err;
  kernel<<<dim3(b * p.h, (own + S::BLOCK - 1) / S::BLOCK), S::THREADS, smem,
           st>>>(r1, r2, l1, l2, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit

// Defines fewbit::flash_backward_d<D>, the launcher of F2 (dkv) and F3 in
// both types at D.
#define FEWBIT_FLASH_BACKWARD_D(D)                                         \
  namespace fewbit {                                                      \
  int flash_backward_d##D(const FlashParams& p, int b, bool bf16, bool dkv, \
                          cudaStream_t st) {                               \
    if (dkv)                                                               \
      return bf16 ? launch_backward<__nv_bfloat16, D, true>(p, b, st)     \
                  : launch_backward<float, D, true>(p, b, st);             \
    return bf16 ? launch_backward<__nv_bfloat16, D, false>(p, b, st)      \
                : launch_backward<float, D, false>(p, b, st);              \
  }                                                                        \
  }
