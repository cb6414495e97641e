// Flash attention's backward on the tensor cores, the dK/dV kernel (F2) and
// the dQ kernel (F3), at every head dimension d = 128 c above 128, as JAX's
// TPU kernels take every multiple of 128 there: the kernel template and its
// launcher.  flash_backward_wide.cu holds the f32 instances and the entry,
// flash_backward_wide_bf16.cu the bf16 ones, so that they build in parallel.
//
// Replaces JAX's Pallas TPU library kernels _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/
// flash_attention.py) at those head dimensions; the functions are
// flash_backward.cuh's.
//
// What bounds it on this card: the functions' own work, 4 (F2) and 3 (F3)
// products of 2 d operations per unmasked pair (at Pythia-1B's (2, 8, 2048,
// 256) causal 0.0695 and 0.0521 ms in bf16, 0.4167 and 0.3125 ms in f32 as
// three TF32 products).  At d = 256 a thread cannot hold the d / 2
// registers of dK and of dV for 64 rows, and the block's own rows over all
// of d (K and V in F2, Q and dO in F3) fill 64 KB in bf16 and 128 KB in
// f32.  The design (flash_hopper.cuh, hb_wide_bwd):
// - A block owns 64 own rows and NJ chunks of 128 columns of its outputs:
//   ceil(c / NJ) blocks per row tile.  Its two consumer warpgroups share
//   the rows and split the work by operand, so that a block computes each
//   first product once: F2's first warpgroup computes S^T = K Q^T, P, and
//   dV += P^T dO over the block's chunks, its second dP^T = V dO^T, dS, and
//   dK += dS^T Q; F3's first computes S = Q K^T and P, its second
//   dP = dO V^T and dS, and each sums one half (64 columns) of each of the
//   block's chunks of dQ += dS K.  P (and in F3 dS) passes between them
//   through shared memory as f32 fragments (each thread reads what its
//   twin wrote), handed over by mbarriers; the second products take it as
//   their A operand from registers.
// - Registers: ptxas compiles every thread of the block to the launch's
//   budget (setmaxnreg does not raise it for the consumers' code), and nine
//   or twelve warps put three on one of the SM's register files: 168 a
//   thread; eight warps have 255.  bf16 runs no producer warps: a warp
//   of the dS side issues every TMA load (a lane a box) once both
//   warpgroups have freed the stage, so the consumers have 255 registers and
//   F2 owns NJ = 2 chunks (128 of dV or dK beside a 64 x 64 first
//   product): one block a row tile at c = 2, every product computed once.
//   F3 above c = 2 owns NJ = 4 (its halves of dQ take 32 registers a
//   chunk): one block a row tile streams the own rows up to c = 4.
//   f32 needs a producer warpgroup (384 threads): 168 registers hold one
//   chunk of dK or dV, so f32 F2 owns NJ = 1 (at c = 2 the two blocks of a
//   row tile each compute the first products); F3, whose halves of dQ take
//   32 registers a chunk, NJ = 2.  The row values of a looped tile (lse,
//   di, segment ids) go straight to the registers of the threads whose
//   fragment columns they are, read when the tile starts.
// - The first products contract over all of d: the looped tile's operands
//   come through a ring, a slice of columns a stage, and accumulate in the
//   order 0 .. d - 1, so the blocks of a row tile hold the same P and dS to
//   the bit.  bf16 runs 64-row tiles (the first products at N = 64); at
//   c = 2 the own rows are loaded once by TMA and stay resident, a stage is
//   a chunk of the looped Q and dO (F2) or K and V (F3), and the second
//   products read B, MN-major, from the same stages, held until both
//   warpgroups are done (four stages: two tiles).  Above c = 2 a stage
//   carries the own rows' chunk beside the looped one, and the block's
//   chunks of the second products' operands come again by TMA into slots
//   of their own (part 2).
// - f32 runs 32-row tiles and slices of 32 columns: a stage holds the own
//   rows' raw slice (by TMA; the consumers split their A fragments in
//   registers) and the looped slice's TF32 hi and lo planes (cp.async and
//   the producer's split), 32 KB, four stages.  tf32 wgmma reads B K-major
//   only, so the producer writes the block's chunks of the second
//   products' operands into part 2 as transposed, k-permuted hi and lo
//   planes while their slices pass.  The own rows are streamed again for
//   every looped tile: resident, they alone would take 128 KB.
// - The cost left: each of a row tile's ceil(c / NJ) blocks computes the
//   first products, so F2 does (ceil(c / NJ) + 1) / 2 and F3
//   (2 ceil(c / NJ) + 1) / 3 times the function's work (at c = 2: 1, but
//   f32 F2 1.5).  The bounds stay the functions' own work.
//   Nothing is summed across blocks and each output element is summed by
//   one warpgroup in a fixed order: no atomics, bitwise repeatable.
#pragma once

#include <math.h>

#include <type_traits>

#include "flash_hopper.cuh"

namespace fewbit {

// The bf16 launcher (flash_backward_wide_bf16.cu).
int flash_backward_wide_bf16(const FlashParams& p, int b, int chunks,
                             bool dkv, cudaStream_t st);

namespace {

// The plan of hb_wide_bwd as constants, and the byte layout of a stage
// (the own rows' slices unless RES, then the looped operands' slices),
// of a part-2 slot (F2 two operands, F3 one; f32 as transposed planes of
// 128 rows of d) and of an exchange buffer (64 x TILE f32).
template <typename T, bool DKV, bool RES>
struct WideBwd {
  static constexpr int ELT = sizeof(T);
  static constexpr bool BF16 = ELT == 2;
  static constexpr HbWideBwd PLAN = hb_wide_bwd(BF16, DKV, RES ? 2 : 3);
  static_assert(PLAN.res == RES, "resident own rows: bf16 at c = 2 only");
  static constexpr int TILE = PLAN.tile;
  static constexpr int SLICE = PLAN.slice;
  static constexpr int STAGES = PLAN.stages;
  static constexpr int NJ = PLAN.nj;
  static constexpr int PARTS = BF16 ? 1 : 2;
  static constexpr int SUBS = SLICE * ELT / 128;  // sub-tiles of a slice row
  static constexpr int SPC = FLASH_CHUNK / SLICE;  // slices of a chunk
  static constexpr int OWN_SUB = 64 * 128;
  static constexpr int OWN_SLICE = SUBS * OWN_SUB;
  static constexpr int OWN_CHUNK = 64 * FLASH_CHUNK * ELT;  // resident
  static constexpr int LOOP_SUB = TILE * 128;
  static constexpr int LOOP_PLANE = SUBS * LOOP_SUB;
  static constexpr int LOOP_SLICE = PARTS * LOOP_PLANE;
  static constexpr int LOOP_AT = RES ? 0 : 2 * OWN_SLICE;
  static constexpr int STAGE_BYTES = LOOP_AT + 2 * LOOP_SLICE;
  static constexpr int SLOT_PLANE = TILE * FLASH_CHUNK * ELT;
  static constexpr int SLOT_OP = PARTS * SLOT_PLANE;
  static constexpr int SLOT_BYTES = (DKV ? 2 : 1) * SLOT_OP;
  static constexpr int XCH = 64 * TILE;  // floats of an exchange buffer
  static constexpr int KS = SLICE * ELT / 32;  // k steps of a stage
  static constexpr int KT = TILE * ELT / 32;  // k steps over looped rows
  // A thread's accumulator floats per chunk: F2 a whole chunk (N = 128),
  // F3 a half (N = 64).
  static constexpr int NA = DKV ? FLASH_CHUNK / 2 : FLASH_CHUNK / 4;
  static constexpr int PRODUCERS = PLAN.producers;
  static constexpr int THREADS = 256 + PRODUCERS;
  static constexpr int SMEM = wide_bwd_smem(BF16, DKV, RES ? 2 : 3);
};

// A thread's TILE / 2 fragment floats into an exchange buffer, float4 i of
// thread lt at float 4 (128 i + lt) (a warp's stores in 512 consecutive
// bytes), and back.
template <int N>
__device__ __forceinline__ void put_fragment(float* xb, const float (&v)[N],
                                             int lt) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    *reinterpret_cast<float4*>(xb + 4 * (128 * i + lt)) =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
template <int N>
__device__ __forceinline__ void get_fragment(float (&v)[N], const float* xb,
                                             int lt) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(xb + 4 * (128 * i + lt));
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// F2 (DKV) or F3.  map_r1, map_r2: the block's own operands (K and V in F2,
// Q and dO in F3), boxes of 64 rows; map_l1, map_l2: the looped ones (Q and
// dO in F2, K and V in F3), boxes of TILE rows, read by TMA for bf16 only.
// chunks: c; blockIdx.x = (batch x head) ceil(c / NJ) + the block's group
// of chunks.
template <typename T, bool DKV, bool RES>
__global__ void __launch_bounds__(WideBwd<T, DKV, RES>::THREADS, 1)
    flash_backward_wide_kernel(const __grid_constant__ CUtensorMap map_r1,
                               const __grid_constant__ CUtensorMap map_r2,
                               const __grid_constant__ CUtensorMap map_l1,
                               const __grid_constant__ CUtensorMap map_l2,
                               FlashParams p, int chunks) {
  using namespace hopper;
  using S = WideBwd<T, DKV, RES>;
  constexpr int TILE = S::TILE;
  extern __shared__ uint8_t smem_raw[];
  const int c = RES ? 2 : chunks;
  uint8_t* res = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = res + (RES ? 2 * 2 * S::OWN_CHUNK : 0);
  uint8_t* part2 = ring + S::STAGES * S::STAGE_BYTES;
  float* xch_p = reinterpret_cast<float*>(part2 +
                                          (RES ? 0 : S::NJ * S::SLOT_BYTES));
  float* xch_ds = xch_p + S::XCH;  // F3 only
  uint64_t* full =
      reinterpret_cast<uint64_t*>(xch_p + (DKV ? 1 : 2) * S::XCH);
  uint64_t* empty = full + S::STAGES;
  uint64_t* full2 = empty + S::STAGES;
  uint64_t* empty2 = full2 + S::NJ;
  uint64_t* pfull = empty2 + S::NJ;
  uint64_t* pempty = pfull + 1;
  uint64_t* dsfull = pempty + 1;
  uint64_t* dsempty = dsfull + 1;
  uint64_t* resb = dsempty + 1;

  const int tid = threadIdx.x;
  const int groups = (c + S::NJ - 1) / S::NJ;
  const int bh = blockIdx.x / groups;
  const int j0 = S::NJ * (blockIdx.x - bh * groups);
  const int nq = min(S::NJ, c - j0);  // the block's chunks j0 .. j0 + nq - 1
  const int bi = bh / p.h, hi = bh % p.h;
  // Under the causal mask the first kv blocks and the last query blocks
  // have the most tiles: those of every head start first.
  const int row0 = (DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * 64;
  const int n_res = DKV ? p.sk : p.sq, n_loop = DKV ? p.sq : p.sk;
  int t0 = 0, t1 = (n_loop + TILE - 1) / TILE;
  if (p.causal) {
    if (DKV)
      t0 = row0 / TILE;
    else
      t1 = min(t1, (min(row0 + 64, p.sq) - 1) / TILE + 1);
  }
  const int* seg_loop = DKV ? p.seg_q : p.seg_kv;
  const int* seg_res = DKV ? p.seg_kv : p.seg_q;
  const float* lse = p.lse_in + (long long)bh * p.sq;
  const float* di = p.di + (long long)bh * p.sq;

  if (tid == 0) {
    // A full barrier counts the f32 producer's threads, or in bf16 the one
    // thread that issues the loads (its arrival carries their bytes).
    constexpr int ARRIVALS = S::PRODUCERS > 0 ? S::PRODUCERS : 1;
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], ARRIVALS);
      mbar_init(&empty[i], 256);
    }
    for (int q = 0; q < S::NJ; ++q) {
      mbar_init(&full2[q], ARRIVALS);
      mbar_init(&empty2[q], 256);
    }
    mbar_init(pfull, 128);
    mbar_init(pempty, 128);
    mbar_init(dsfull, 128);
    mbar_init(dsempty, 128);
    mbar_init(resb, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // ----------------------------------------------------------------------
    // The f32 producer warpgroup (bf16 has none).
    // ----------------------------------------------------------------------
    if constexpr (!S::BF16) {
      const int ptid = tid - 256;
      const Strides& st1 = DKV ? p.st_q : p.st_k;
      const Strides& st2 = DKV ? p.st_do : p.st_v;
      const float* f1 = static_cast<const float*>(DKV ? p.q : p.k) +
                        bi * st1.b + hi * st1.h;
      const float* f2 = static_cast<const float*>(DKV ? p.dout : p.v) +
                        bi * st2.b + hi * st2.h;
      int st = 0;
      uint32_t ph = 0, ph2 = 0;
      // A stage whose copies were issued is split, transposed into part 2
      // where it is one of the block's chunks, and handed over once the
      // copies of the two stages after it fly (st >= 0: pending; slot q or
      // -1, its slice qq of the chunk, the tile's parity of part 2).
      struct Pending {
        int st, q, qq;
        uint32_t ph2;
      };
      Pending p0 = {-1, -1, 0, 0}, p1 = p0;
      auto finish = [&](const Pending& pd) {
        uint8_t* lp = ring + pd.st * S::STAGE_BYTES + S::LOOP_AT;
        split_fetched<TILE, S::SLICE, 128>(lp, ptid);
        split_fetched<TILE, S::SLICE, 128>(lp + S::LOOP_SLICE, ptid);
        fence_proxy_async();  // the stores, before wgmma reads them
        mbar_arrive(&full[pd.st]);
        if (pd.q >= 0) {
          // The slice of the block's chunk, into slot q once the consumers
          // are done with the last tile's.
          bar_sync(1, S::PRODUCERS);  // every warp's split is done
          if (pd.qq == 0) mbar_wait(&empty2[pd.q], pd.ph2 ^ 1);
          uint8_t* rows =
              part2 + pd.q * S::SLOT_BYTES + S::SLICE * 128 * pd.qq;
          // Rows 32 qq .. 32 qq + 31 of the slot's planes of 128 rows.
          transpose_planes<TILE, S::SLICE, 128, S::SLOT_PLANE>(rows, lp,
                                                               ptid);
          if constexpr (DKV)
            transpose_planes<TILE, S::SLICE, 128, S::SLOT_PLANE>(
                rows + S::SLOT_OP, lp + S::LOOP_SLICE, ptid);
          fence_proxy_async();
          if (pd.qq == S::SPC - 1) mbar_arrive(&full2[pd.q]);
          // No warp fetches into this stage again while a slower one still
          // transposes it.
          bar_sync(1, S::PRODUCERS);
        }
      };
      for (int t = t0; t < t1; ++t) {
        const int l0 = t * TILE;
        for (int i = 0; i < c; ++i) {
          const int q = i - j0;
          const bool mine = q >= 0 && q < nq;
          for (int qq = 0; qq < S::SPC; ++qq) {
            mbar_wait(&empty[st], ph ^ 1);
            uint8_t* stage = ring + st * S::STAGE_BYTES;
            uint8_t* lp = stage + S::LOOP_AT;
            const int cs = FLASH_CHUNK * i + S::SLICE * qq;
            if (ptid == 0) {  // the own rows' slice
              mbar_expect_tx(&full[st], S::LOOP_AT);
              tma_load_4d(stage, &map_r1, &full[st], cs, row0, hi, bi);
              tma_load_4d(stage + S::OWN_SLICE, &map_r2, &full[st], cs, row0,
                          hi, bi);
            }
            fetch_tile<TILE, S::SLICE, 128>(lp, f1 + cs, st1.s, l0, n_loop,
                                            ptid);
            fetch_tile<TILE, S::SLICE, 128>(lp + S::LOOP_SLICE, f2 + cs,
                                            st2.s, l0, n_loop, ptid);
            asm volatile("cp.async.commit_group;" ::: "memory");
            if (p0.st >= 0) {
              // The thread's copies of the stage two before have landed.
              asm volatile("cp.async.wait_group 2;" ::: "memory");
              finish(p0);
            }
            p0 = p1;
            p1 = {st, mine ? q : -1, qq, ph2};
            if (++st == S::STAGES) {
              st = 0;
              ph ^= 1;
            }
          }
        }
        ph2 ^= 1;
      }
      if (p0.st >= 0) {
        asm volatile("cp.async.wait_group 1;" ::: "memory");
        finish(p0);
      }
      if (p1.st >= 0) {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        finish(p1);
      }
    }
  } else {
    // ----------------------------------------------------------------------
    // The consumer warpgroups: wg 0 the P side, wg 1 the dS side.
    // ----------------------------------------------------------------------
    const int wg = tid >> 7, lt = tid & 127;
    const int warp = lt >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int rloc = 16 * warp + g;  // the thread's rows: +0, +8
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
    // The second products' operand of this warpgroup: F2 dO (wg 0, for dV)
    // or Q (wg 1, for dK); F3 K.
    const int op = DKV ? 1 - wg : 0;
    float acc[S::NJ][S::NA];
#pragma unroll
    for (int q = 0; q < S::NJ; ++q)
#pragma unroll
      for (int i = 0; i < S::NA; ++i) acc[q][i] = 0.f;
    const uint32_t ring_u = smem_u32(ring);

    // bf16: the dS side's first warp issues every load, ahead of the
    // consumers: ring item (it, ii) (tile, chunk) into stage ist, STAGES
    // items ahead (RES: two tiles, each held for the second products and
    // refilled with the tile after the next while the dS side waits for P
    // of the next; else a chunk a stage, refilled as soon as both
    // warpgroups are done with it), and part 2 a tile ahead.  Its first
    // lane waits for the stage and arms the barrier, then each copy (an
    // operand's 64-column sub-tile) goes out from a lane of its own.
    const bool issuer = S::BF16 && wg == 1 && warp == 0;
    int it = t0, ii = 0, ist = 0;
    uint32_t iph = 0;
    auto issue = [&]() {
      if (it >= t1) return;
      if (lane == 0) {
        mbar_wait(&empty[ist], iph ^ 1);
        mbar_arrive_expect_tx(&full[ist], S::STAGE_BYTES);
      }
      __syncwarp();
      // Lane l: sub-tile l % SUBS of operand l / SUBS (the own rows' two
      // first unless RES, then the looped tile's two).
      constexpr int OPS = RES ? 2 : 4;
      if (lane < OPS * S::SUBS) {
        const int sub = lane % S::SUBS, o = lane / S::SUBS + (RES ? 2 : 0);
        uint8_t* stage = ring + ist * S::STAGE_BYTES;
        const int cc = FLASH_CHUNK * ii + sub * (128 / S::ELT);
        if (o < 2)
          tma_load_4d(stage + o * S::OWN_SLICE + sub * S::OWN_SUB,
                      o == 0 ? &map_r1 : &map_r2, &full[ist], cc, row0, hi,
                      bi);
        else
          tma_load_4d(stage + S::LOOP_AT + (o - 2) * S::LOOP_SLICE +
                          sub * S::LOOP_SUB,
                      o == 2 ? &map_l1 : &map_l2, &full[ist], cc, it * TILE,
                      hi, bi);
      }
      if (++ii == c) {
        ii = 0;
        ++it;
      }
      if (++ist == S::STAGES) {
        ist = 0;
        iph ^= 1;
      }
    };
    // bf16 above c = 2: the block's chunk j0 + q of tile t again, into slot
    // q once both warpgroups are done with the tile before's.
    auto issue_part2 = [&](int t, int q) {
      if (t >= t1) return;
      if (lane == 0) {
        mbar_wait(&empty2[q], ((t - t0) & 1) ^ 1);
        mbar_arrive_expect_tx(&full2[q], S::SLOT_BYTES);
      }
      __syncwarp();
      if (lane < (DKV ? 4 : 2)) {
        const int sub = lane & 1, o = lane >> 1;
        tma_load_4d(part2 + q * S::SLOT_BYTES + o * S::SLOT_OP +
                        sub * S::LOOP_SUB,
                    o == 0 ? &map_l1 : &map_l2, &full2[q],
                    FLASH_CHUNK * (j0 + q) + sub * 64, t * TILE, hi, bi);
      }
    };
    if (issuer) {
      if constexpr (RES) {  // the own rows, once: a lane a sub-tile
        if (lane == 0) mbar_arrive_expect_tx(resb, 2 * 2 * S::OWN_CHUNK);
        __syncwarp();
        if (lane < 8) {
          const int i = lane & 1, sub = (lane >> 1) & 1, o = lane >> 2;
          tma_load_4d(res + o * 2 * S::OWN_CHUNK + i * S::OWN_CHUNK +
                          sub * S::OWN_SUB,
                      o == 0 ? &map_r1 : &map_r2, resb,
                      FLASH_CHUNK * i + sub * 64, row0, hi, bi);
        }
      }
      for (int n = 0; n < S::STAGES; ++n) issue();
      if constexpr (!RES)
        for (int q = 0; q < nq; ++q) issue_part2(t0, q);
    }
    if (RES) mbar_wait(resb, 0);

    int st = 0;
    uint32_t ph = 0, ph2 = 0, xph = 0;
    for (int t = t0; t < t1; ++t) {
      const int l0 = t * TILE;
      // The row values of the tile's columns this thread's fragment holds
      // (F2: lse on the P side, di on the dS side; the P side's segment
      // ids), read now: the first products hide their latency.
      float rv[TILE / 4];
      int rvid[TILE / 4];
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = l0 + 8 * i + 2 * tq + e;
          const bool in = col < n_loop;
          rv[2 * i + e] = DKV && in ? (wg == 0 ? lse : di)[col] : 0.f;
          rvid[2 * i + e] = wg == 0 && seg_loop != nullptr && in
                                ? seg_loop[(long long)bi * n_loop + col]
                                : 0;
        }
      // F2: S^T (wg 0) or dP^T (wg 1); F3: S or dP.  Then P or dS.
      float v[TILE / 2];
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) v[i] = 0.f;
      const int held = st;  // RES: chunk i of the tile is at held + i
      // -- The first product over d, stage by stage in order. ------------
      for (int i = 0; i < c; ++i) {
        for (int qq = 0; qq < S::SPC; ++qq) {
          mbar_wait(&full[st], ph);
          __syncwarp();  // wgmma is .aligned: the warp converges first
          const uint32_t su = ring_u + st * S::STAGE_BYTES;
          const uint32_t b = su + S::LOOP_AT + wg * S::LOOP_SLICE;
          if constexpr (S::BF16) {
            const uint32_t a = RES ? smem_u32(res) + wg * 2 * S::OWN_CHUNK +
                                         i * S::OWN_CHUNK
                                   : su + wg * S::OWN_SLICE;
            fence_operands(v);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < S::KS; ++ks) {
              const uint32_t ka = (ks / 4) * S::OWN_SUB + 32 * (ks % 4);
              const uint32_t kb = (ks / 4) * S::LOOP_SUB + 32 * (ks % 4);
              Wgmma<TILE>::bf16_ss(v, desc_sw(a + ka, 128),
                                   desc_sw(b + kb, 128));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_operands(v);
          } else {
            tf32_chunk_products<TILE, 64, S::KS, 1>(
                v, ring + st * S::STAGE_BYTES + wg * S::OWN_SLICE, b, rloc,
                tq);
          }
          // RES: the block's chunks stay for the second products.
          if (!RES || i - j0 < 0 || i - j0 >= nq) {
            mbar_arrive(&empty[st]);
            if (issuer) issue();
          }
          if (++st == S::STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
      // -- Between the products: P (wg 0), dS (wg 1). ---------------------
      // The fragment's rows are the block's own side, its columns the
      // looped tile's: F2 rows are keys and columns queries, F3 the other
      // way round.
      if (wg == 0) {
        const bool diagonal =
            p.causal && (DKV ? row0 + 63 > l0 : l0 + TILE - 1 > row0);
        bool by_segment = seg_loop != nullptr;
        if (by_segment) by_segment = !one_segment_ids(rvid, rid);
        const bool masked = by_segment || diagonal || l0 + TILE > n_loop;
        auto probabilities = [&](auto masked_c) {
          constexpr bool MASKED = decltype(masked_c)::value;
#pragma unroll
          for (int i = 0; i < TILE / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * i + 2 * h + e;
                const int rowg = row0 + rloc + 8 * h;
                const int colg = l0 + 8 * i + 2 * tq + e;
                const float lse_v = DKV ? rv[2 * i + e] : rlse[h];
                if (MASKED) {
                  const int r = DKV ? colg : rowg, cc = DKV ? rowg : colg;
                  bool keep = !by_segment || rid[h] == rvid[2 * i + e];
                  if (p.causal) keep = keep && cc <= r;
                  float val = v[idx] * p.scale;
                  if (!keep) val += MASK_VALUE;
                  // A looped row past the sequence takes no part.
                  v[idx] = colg < n_loop ? ex2((val - lse_v) * LOG2E) : 0.f;
                } else {
                  v[idx] = ex2(fmaf(v[idx], scale_log2, -LOG2E * lse_v));
                }
              }
        };
        if (masked)
          probabilities(std::true_type{});
        else
          probabilities(std::false_type{});
        mbar_wait(pempty, xph ^ 1);
        put_fragment(xch_p, v, lt);
        mbar_arrive(pfull);
        if (!DKV) {  // F3: dS back from the dS side
          mbar_wait(dsfull, xph);
          get_fragment(v, xch_ds, lt);
          mbar_arrive(dsempty);
        }
      } else {
        if (RES && issuer && t > t0) {
          // While P is computed: the P side is past the tile before (its
          // first products of this one are done), whose stages take the
          // tile after this one.
          for (int n = 0; n < c; ++n) issue();
        }
        mbar_wait(pfull, xph);
#pragma unroll
        for (int i = 0; i < TILE / 8; ++i) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(xch_p + 4 * (128 * i + lt));
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * i + 2 * h + e;
              const float di_v = DKV ? rv[2 * i + e] : rdi[h];
              v[idx] = pv[2 * h + e] * (v[idx] - di_v);  // sm_scale: at the
                                                          // store
            }
        }
        mbar_arrive(pempty);
        if (!DKV) {
          mbar_wait(dsempty, xph ^ 1);
          put_fragment(xch_ds, v, lt);
          mbar_arrive(dsfull);
        }
      }
      xph ^= 1;
      // -- The second products: acc[q] += v L_j, over the tile's rows, for
      // each of the block's chunks j = j0 + q, v from registers. ----------
      if constexpr (S::BF16) {
        uint32_t pk[S::KT][4];
#pragma unroll
        for (int j = 0; j < S::KT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pk[j][r] = pack_bf16(v[8 * j + 2 * r], v[8 * j + 2 * r + 1]);
#pragma unroll
        for (int q = 0; q < S::NJ; ++q) {
          if (q >= nq) break;
          uint32_t bb;
          if constexpr (RES) {
            bb = ring_u + (held + j0 + q) * S::STAGE_BYTES +
                 op * S::LOOP_SLICE;
          } else {
            mbar_wait(&full2[q], ph2);
            __syncwarp();
            bb = smem_u32(part2) + q * S::SLOT_BYTES + op * S::SLOT_OP;
          }
          fence_operands(acc[q]);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < S::KT; ++j) {
            // The tile MN-major: step j is its rows 16 j .. 16 j + 15.
            const uint32_t off = 16 * 128 * j;
            if constexpr (DKV)
              Wgmma<FLASH_CHUNK>::template bf16_rs<1>(
                  acc[q], pk[j], desc_sw(bb + off, 128, S::LOOP_SUB));
            else
              Wgmma<FLASH_CHUNK / 2>::template bf16_rs<1>(
                  acc[q], pk[j], desc_sw(bb + wg * S::LOOP_SUB + off, 128));
          }
          wgmma_commit();
          wgmma_wait<0>();
          keep_alive(pk);
          fence_operands(acc[q]);
          mbar_arrive(RES ? &empty[held + j0 + q] : &empty2[q]);
        }
        if (!RES && issuer) {  // the next tile's part 2
          for (int q = 0; q < nq; ++q) issue_part2(t + 1, q);
        }
      } else {
        // Accumulator columns 2 t, 2 t + 1 of step j are the A fragment's
        // columns t, t + 4: the order transpose_planes wrote B's k in.
        uint32_t vh[TILE / 8][4], vl[TILE / 8][4];
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_tf32(v[4 * j + 2 * (r & 1) + (r >> 1)], vh[j][r], vl[j][r]);
#pragma unroll
        for (int q = 0; q < S::NJ; ++q) {
          if (q >= nq) break;
          mbar_wait(&full2[q], ph2);
          __syncwarp();
          const uint32_t bb = smem_u32(part2) + q * S::SLOT_BYTES +
                              op * S::SLOT_OP + (DKV ? 0 : wg * 64 * 128);
          fence_operands(acc[q]);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < TILE / 8; ++j) {
            const uint64_t dh = desc_sw128(bb + 32 * j);
            const uint64_t dl = desc_sw128(bb + S::SLOT_PLANE + 32 * j);
            using W = Wgmma<DKV ? FLASH_CHUNK : FLASH_CHUNK / 2>;
            W::tf32_rs(acc[q], vh[j], dh);
            W::tf32_rs(acc[q], vh[j], dl);
            W::tf32_rs(acc[q], vl[j], dh);
          }
          wgmma_commit();
          wgmma_wait<0>();
          keep_alive(vh);
          keep_alive(vl);
          fence_operands(acc[q]);
          mbar_arrive(&empty2[q]);
        }
      }
      if (!RES) ph2 ^= 1;
    }

    // F2: wg 0 stores dV, wg 1 dK (times sm_scale); F3: dQ (times
    // sm_scale), wg w the columns 64 w .. 64 w + 63 of each chunk.
    const Strides& sto = DKV ? (wg == 0 ? p.st_dv : p.st_dk) : p.st_dq;
    T* out = static_cast<T*>(DKV ? (wg == 0 ? p.dv : p.dk) : p.dq) +
             bi * sto.b + hi * sto.h + (DKV ? 0 : 64 * wg);
    const float scale = DKV && wg == 0 ? 1.f : p.scale;
#pragma unroll
    for (int q = 0; q < S::NJ; ++q) {
      if (q >= nq) break;
      T* outq = out + FLASH_CHUNK * (j0 + q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + rloc + 8 * h;
        if (row >= n_res) continue;
#pragma unroll
        for (int i = 0; i < S::NA / 4; ++i) {
          const int idx = 4 * i + 2 * h, col = 8 * i + 2 * tq;
          store2(outq + (long long)row * sto.s + col, acc[q][idx] * scale,
                 acc[q][idx + 1] * scale);
        }
      }
    }
  }
}

template <typename T, bool DKV, bool RES>
int launch_backward_wide(const FlashParams& p, int b, int chunks,
                         cudaStream_t st) {
  using S = WideBwd<T, DKV, RES>;
  if (b <= 0 || p.h <= 0 || p.sq <= 0 || p.sk <= 0 || chunks < 2 ||
      RES != (S::BF16 && chunks == 2))
    return -1;
  const int d = FLASH_CHUNK * chunks;
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
      operand_map<T>(&r1, own1, so1, b, p.h, own, d, 64, 128) &&
      operand_map<T>(&r2, own2, so2, b, p.h, own, d, 64, 128) &&
      (!S::BF16 ||
       (operand_map<T>(&l1, loop1, sl1, b, p.h, loop, d, S::TILE, 128) &&
        operand_map<T>(&l2, loop2, sl2, b, p.h, loop, d, S::TILE, 128)));
  if (!ok) return -2;
  auto kernel = flash_backward_wide_kernel<T, DKV, RES>;
  static_assert(S::SMEM <= HB_SMEM_LIMIT, "the block's shared memory");
  static unsigned allowed = 0;
  if (const int err = allow_smem(kernel, S::SMEM, allowed)) return err;
  const int groups = (chunks + S::NJ - 1) / S::NJ;
  kernel<<<dim3(b * p.h * groups, (own + 63) / 64), S::THREADS, S::SMEM,
           st>>>(r1, r2, l1, l2, p, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fewbit
