// Flash attention's forward on the tensor cores (F1) at every head
// dimension d = 128 c above 128, as JAX's TPU kernel takes every multiple of
// 128 there: two instantiations per type (the query rows resident or not),
// whose number of chunks c is a launch argument.
//
// Replaces JAX's Pallas TPU library kernel _flash_attention_impl
// (jax/experimental/pallas/ops/tpu/flash_attention.py) at those head
// dimensions; the function is flash_forward.cuh's.
//
// What bounds it on this card: the function's own work is flash_forward.cuh's
// (2 products of 2 d operations per unmasked pair; at Pythia-1B's (2, 8,
// 2048, 256) causal 0.0348 ms in bf16 and 0.2083 ms in f32 as three TF32
// products).  At d = 256 a thread's d / 2 registers of o for 64 query rows
// (128) leave room beside S and P only where the block has eight warps
// (255 registers a thread; nine or more compile to 168), and the f32
// block's query rows alone take 64 KB.  So (flash_hopper.cuh, hb_wide_fwd):
// - A block owns 64 query rows per consumer warpgroup and NJ = 2 chunks of
//   128 columns of o: ceil(c / 2) blocks per row tile (adjacent in x, so
//   they share the L2's copies of k and v), one at c = 2, where every
//   product is computed once.
// - S = Q K^T contracts over all of d: K's chunks come through the ring,
//   one chunk a stage, and accumulate into one fragment in chunk order
//   0 .. c - 1.  Every block of a row tile so holds the same S to the bit,
//   and computes m, l and lse with the same arithmetic: the chunks of o
//   agree, and only the block of chunk 0 writes lse.  Nothing is summed
//   across blocks.
// - The query rows are loaded once by TMA and stay resident where they fit
//   beside the ring (RES: bf16 up to c = 4, f32 at c = 2); above, a stage
//   carries their chunk beside K's, as every block needs all of d for S.
// - bf16 (256 threads, no producer warps): the first warp of the second
//   warpgroup issues every TMA load, one chunk of K or V (16 KB) a stage,
//   a tile's c chunks of K and then its chunks of V for the block's
//   columns, STAGES items ahead; both operands of S from shared memory, V
//   read MN-major from its stage.  A step issues P V of the tile before
//   (P packed in registers) and S of the next as one group, so that the
//   tensor cores see both products of a step at once and a softmax waits
//   for one group.
// - f32: a producer warpgroup fetches K's chunks (cp.async) and splits
//   them into TF32 hi and lo planes in the ring, and V's chunks of the
//   block's columns through a staging pair of planes into part 2, a slot a
//   chunk, transposed and k-permuted as flash_forward.cuh's.  The consumer
//   warpgroup splits its A fragments from the raw query rows in registers
//   (tf32_chunk_products) and takes P V from registers (tf32_rows_product).
// - The segment ids of a kv tile's columns go straight to the registers of
//   the threads whose fragment columns they are, read before S.
// - The cost left: above c = 2 each of a row tile's ceil(c / 2) blocks
//   computes S over all of d, so F1 does (ceil(c / 2) + 1) / 2 times the
//   function's work (1.5 times at d = 512).  Its bound stays the
//   function's own work.
#include "flash_forward.cuh"

namespace fewbit {
namespace {

// The plan of hb_wide_fwd as constants per element type and residency,
// and the byte layout of the query rows' chunk (sub-tiles of BLOCK rows of
// 128 bytes), of a chunk of K or V (sub-tiles of TILE rows; f32 as hi and
// lo planes) and of a ring stage (the query rows' chunk unless RES, then
// the chunk of K or V).
template <typename T, bool RES>
struct WideFwd {
  static constexpr int ELT = sizeof(T);
  static constexpr bool BF16 = ELT == 2;
  static constexpr HbWideFwd PLAN = hb_wide_fwd(BF16, RES ? 2 : 5);
  static_assert(PLAN.res == RES, "both residencies at c = 2 and 5");
  static constexpr int TILE = PLAN.tile;
  static constexpr int NJ = PLAN.nj;
  static constexpr int WGS = BF16 ? 2 : 1;
  static constexpr int BLOCK = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int PRODUCERS = BF16 ? 0 : HB_PRODUCERS;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int PARTS = BF16 ? 1 : 2;
  static constexpr int SUB = FLASH_CHUNK * ELT / 128;  // sub-tiles a row
  static constexpr int KD = FLASH_CHUNK * ELT / 32;    // k steps of a chunk
  static constexpr int KT = TILE * ELT / 32;  // k steps over a tile's rows
  static constexpr int Q_SUB = BLOCK * 128;
  static constexpr int Q_CHUNK = SUB * Q_SUB;
  static constexpr int L_SUB = TILE * 128;
  static constexpr int L_PLANE = SUB * L_SUB;
  static constexpr int L_CHUNK = PARTS * L_PLANE;
  static constexpr int LOOP_AT = RES ? 0 : Q_CHUNK;  // K's or V's chunk
  static constexpr int STAGE_BYTES = LOOP_AT + L_CHUNK;
};

// map_q: boxes of BLOCK query rows; map_k, map_v: boxes of TILE kv rows,
// read by TMA for bf16 only.  chunks: c; blockIdx.x = (batch x head)
// ceil(c / NJ) + the block's group of chunks.
template <typename T, bool RES>
__global__ void __launch_bounds__(WideFwd<T, RES>::THREADS, 1)
    flash_forward_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              FlashParams p, int chunks) {
  using namespace hopper;
  using S = WideFwd<T, RES>;
  constexpr int TILE = S::TILE;
  const int c = chunks;
  const int stages = hb_wide_fwd(S::BF16, c).stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qres = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qres + (RES ? c * S::Q_CHUNK : 0);
  uint8_t* part2 = ring + stages * S::STAGE_BYTES;  // f32
  uint8_t* staging = part2 + (S::BF16 ? 0 : S::NJ * S::L_CHUNK);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + (S::BF16 ? 0 : S::L_CHUNK));
  uint64_t* empty = full + stages;
  uint64_t* full2 = empty + stages;  // f32: part 2's slots
  uint64_t* empty2 = full2 + S::NJ;
  uint64_t* qbar = empty2 + S::NJ;

  const int tid = threadIdx.x;
  const int groups = (c + S::NJ - 1) / S::NJ;
  const int bh = blockIdx.x / groups;
  const int j0 = S::NJ * (blockIdx.x - bh * groups);
  const int nq = min(S::NJ, c - j0);  // the block's chunks j0 .. j0 + nq - 1
  const int bi = bh / p.h, hi = bh % p.h;
  // Under the causal mask the last query blocks have the most tiles: those
  // of every head start first.
  const int row0 = (gridDim.y - 1 - blockIdx.y) * S::BLOCK;
  int t1 = (p.sk + TILE - 1) / TILE;
  if (p.causal) t1 = min(t1, (min(row0 + S::BLOCK, p.sq) - 1) / TILE + 1);

  if (tid == 0) {
    // A full barrier counts the f32 producer's threads, or in bf16 the one
    // thread that issues the loads (its arrival carries their bytes).
    constexpr int ARRIVALS = S::BF16 ? 1 : S::PRODUCERS;
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], ARRIVALS);
      mbar_init(&empty[i], S::CONSUMERS);
    }
    for (int q = 0; q < S::NJ; ++q) {
      mbar_init(&full2[q], ARRIVALS);
      mbar_init(&empty2[q], S::CONSUMERS);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ----------------------------------------------------------------------
    // The f32 producer warpgroup (bf16 has none).
    // ----------------------------------------------------------------------
    if constexpr (!S::BF16) {
      const int ptid = tid - S::CONSUMERS;
      if (RES && ptid == 0) {  // the query rows, once
        mbar_arrive_expect_tx(qbar, c * S::Q_CHUNK);
        for (int i = 0; i < c; ++i)
#pragma unroll
          for (int sub = 0; sub < S::SUB; ++sub)
            tma_load_4d(qres + i * S::Q_CHUNK + sub * S::Q_SUB, &map_q, qbar,
                        FLASH_CHUNK * i + sub * 32, row0, hi, bi);
      }
      const float* kf = static_cast<const float*>(p.k) + bi * p.st_k.b +
                        hi * p.st_k.h;
      const float* vf = static_cast<const float*>(p.v) + bi * p.st_v.b +
                        hi * p.st_v.h;
      int st = 0;
      uint32_t ph = 0, ph2 = 0;
      for (int t = 0; t < t1; ++t) {
        const int l0 = t * TILE;
        for (int i = 0; i < c; ++i) {
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* stage = ring + st * S::STAGE_BYTES;
          if (!RES && ptid == 0) {  // the query rows' chunk
            mbar_expect_tx(&full[st], S::Q_CHUNK);
#pragma unroll
            for (int sub = 0; sub < S::SUB; ++sub)
              tma_load_4d(stage + sub * S::Q_SUB, &map_q, &full[st],
                          FLASH_CHUNK * i + sub * 32, row0, hi, bi);
          }
          fetch_tile<TILE, FLASH_CHUNK, 128>(stage + S::LOOP_AT,
                                             kf + FLASH_CHUNK * i, p.st_k.s,
                                             l0, p.sk, ptid);
          asm volatile("cp.async.wait_all;" ::: "memory");
          split_fetched<TILE, FLASH_CHUNK, 128>(stage + S::LOOP_AT, ptid);
          fence_proxy_async();  // the stores, before wgmma reads them
          mbar_arrive(&full[st]);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
        }
        // V's chunks of the block's columns, each through the staging
        // planes into its slot of part 2 once the consumer is done with the
        // last tile's.
        for (int q = 0; q < nq; ++q) {
          fetch_tile<TILE, FLASH_CHUNK, 128>(
              staging, vf + FLASH_CHUNK * (j0 + q), p.st_v.s, l0, p.sk, ptid);
          asm volatile("cp.async.wait_all;" ::: "memory");
          split_fetched<TILE, FLASH_CHUNK, 128>(staging, ptid);
          // Every warp's chunks are split before any warp transposes them.
          bar_sync(1, HB_PRODUCERS);
          mbar_wait(&empty2[q], ph2 ^ 1);
          transpose_planes<TILE, FLASH_CHUNK, 128>(part2 + q * S::L_CHUNK,
                                                   staging, ptid);
          fence_proxy_async();
          mbar_arrive(&full2[q]);
          // No warp copies the next chunk into the staging planes while a
          // slower one still transposes them.
          bar_sync(1, HB_PRODUCERS);
        }
        ph2 ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------------------
    // The consumer warpgroups.
    // ----------------------------------------------------------------------
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
    float o[S::NJ][FLASH_CHUNK / 2];
#pragma unroll
    for (int q = 0; q < S::NJ; ++q)
#pragma unroll
      for (int i = 0; i < FLASH_CHUNK / 2; ++i) o[q][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float x[TILE / 2];        // S, then P
    int rvid[TILE / 4] = {};  // the segment ids of the thread's columns

    // bf16: the second warpgroup's first warp issues every load, STAGES
    // ring items ahead: item (it, ii) is the tile's K chunk ii (with the
    // query rows' chunk unless RES), or for ii >= c V's chunk j0 + ii - c.
    // Its first lane waits for the stage and arms the barrier, then each
    // copy (a 64-column sub-tile) goes out from a lane of its own.
    const bool issuer = S::BF16 && wg == S::WGS - 1 && warp == 0;
    const int items = c + nq;
    int it = 0, ii = 0, ist = 0;
    uint32_t iph = 0;
    auto issue = [&]() {
      if (it >= t1) return;
      const bool k_item = ii < c;
      if (lane == 0) {
        mbar_wait(&empty[ist], iph ^ 1);
        mbar_arrive_expect_tx(&full[ist], k_item ? S::STAGE_BYTES
                                                 : S::L_CHUNK);
      }
      __syncwarp();
      uint8_t* stage = ring + ist * S::STAGE_BYTES;
      if (lane < S::SUB) {
        const int cc = FLASH_CHUNK * (k_item ? ii : j0 + ii - c) + 64 * lane;
        tma_load_4d(stage + S::LOOP_AT + lane * S::L_SUB,
                    k_item ? &map_k : &map_v, &full[ist], cc, it * TILE, hi,
                    bi);
      } else if (!RES && k_item && lane < 2 * S::SUB) {
        const int sub = lane - S::SUB;
        tma_load_4d(stage + sub * S::Q_SUB, &map_q, &full[ist],
                    FLASH_CHUNK * ii + 64 * sub, row0, hi, bi);
      }
      if (++ii == items) {
        ii = 0;
        ++it;
      }
      if (++ist == stages) {
        ist = 0;
        iph ^= 1;
      }
    };
    if (issuer) {
      if (RES) {  // the query rows, once: a lane a sub-tile
        if (lane == 0) mbar_arrive_expect_tx(qbar, c * S::Q_CHUNK);
        __syncwarp();
        if (lane < c * S::SUB)
          tma_load_4d(qres + (lane / S::SUB) * S::Q_CHUNK +
                          (lane % S::SUB) * S::Q_SUB,
                      &map_q, qbar,
                      FLASH_CHUNK * (lane / S::SUB) + 64 * (lane % S::SUB),
                      row0, hi, bi);
      }
      for (int n = 0; n < stages; ++n) issue();
    }
    if (RES) mbar_wait(qbar, 0);

    // The online softmax of the tile at l0, as flash_forward.cuh's.
    auto softmax = [&](int l0, float (&alpha)[2]) {
      bool by_segment = p.seg_q != nullptr;
      if (by_segment) by_segment = !one_segment_ids(rvid, rid);
      const bool diagonal = p.causal && l0 + TILE - 1 > wrow0;
      const bool masked = by_segment || diagonal || l0 + TILE > p.sk ||
                          !(p.scale > 0.f);
      float mx[2] = {m[0], m[1]};
      auto run = [&](auto masked_c) {
        constexpr bool MASKED = decltype(masked_c)::value;
        if (MASKED) {
#pragma unroll
          for (int i = 0; i < TILE / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * i + 2 * h + e;
                const int rowg = row0 + rloc + 8 * h;
                const int colg = l0 + 8 * i + 2 * tq + e;
                bool keep = !by_segment || rid[h] == rvid[2 * i + e];
                if (p.causal) keep = keep && colg <= rowg;
                float val = x[idx] * p.scale;
                if (!keep) val += MASK_VALUE;
                x[idx] = colg < p.sk ? val : -INFINITY;
                mx[h] = fmaxf(mx[h], x[idx]);
              }
        } else {
          float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int idx = 0; idx < TILE / 2; ++idx)
            raw[(idx >> 1) & 1] = fmaxf(raw[(idx >> 1) & 1], x[idx]);
          mx[0] = fmaxf(mx[0], raw[0] * p.scale);
          mx[1] = fmaxf(mx[1], raw[1] * p.scale);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        const bool stay = __all_sync(
            0xffffffffu, (mx[0] - m[0]) * LOG2E <= 8.f &&
                             (mx[1] - m[1]) * LOG2E <= 8.f);
        float mlog2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          alpha[h] = stay ? 1.f : fast_exp2((m[h] - mx[h]) * LOG2E);
          if (!stay) m[h] = mx[h];
          mlog2[h] = m[h] * LOG2E;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int idx = 0; idx < TILE / 2; ++idx) {
          const int h = (idx >> 1) & 1;
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

    // Under the causal mask the tiles from t_end on lie wholly past this
    // warpgroup's rows: it only frees their stages (and part 2's slots).
    const int t_end = p.causal ? min(t1, (wrow0 + 63) / TILE + 1) : t1;
    int st = 0;
    uint32_t ph = 0;
    auto advance = [&] {
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    };
    auto release = [&](int s) {
      mbar_arrive(&empty[s]);
      if (issuer) issue();
    };
    // The segment ids of the tile at l0's columns this thread's fragment
    // holds.
    auto read_ids = [&](int l0) {
      if (p.seg_kv == nullptr) return;
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = l0 + 8 * i + 2 * tq + e;
          rvid[2 * i + e] =
              col < p.sk ? p.seg_kv[(long long)bi * p.sk + col] : 0;
        }
    };
    // After the softmax of a tile: o rescaled by alpha.
    auto rescale = [&](const float (&alpha)[2]) {
      if (alpha[0] == 1.f && alpha[1] == 1.f) return;
#pragma unroll
      for (int q = 0; q < S::NJ; ++q)
#pragma unroll
        for (int idx = 0; idx < FLASH_CHUNK / 2; ++idx)
          o[q][idx] *= alpha[(idx >> 1) & 1];
    };
    if constexpr (S::BF16) {
      // Step t issues O += P V for tile t - 1 (its P packed in px) and
      // S = Q K^T for tile t, consuming the ring in its order (V's chunks
      // of t - 1, then K's of t), then runs tile t's softmax.  Where the
      // query rows are resident a step's stages fit in the ring: the step
      // is one group, and its stages are freed once it is done.  Else
      // (c > 4) each stage's products are retired and the stage freed
      // before the next is waited for.
      uint32_t px[S::KT][4];  // P packed into the m64k16 A fragments
#pragma unroll
      for (int j = 0; j < S::KT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) px[j][r] = 0u;
      // After each stage's products are issued: unless RES, retired and
      // the stage freed.
      auto next = [&]() {
        if (!RES) {
          wgmma_commit();
          wgmma_wait<0>();
          release(st);
        }
        advance();
      };
      for (int t = 0; t <= t1; ++t) {
        const bool pv_live = t > 0 && t - 1 < t_end;
        const bool s_live = t < t_end;
        const int first = st;
        const int n = (t > 0 ? nq : 0) + (t < t1 ? c : 0);
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) x[i] = 0.f;
#pragma unroll
        for (int q = 0; q < S::NJ; ++q) fence_operands(o[q]);
        fence_operands(x);
        if (t > 0) {
#pragma unroll
          for (int q = 0; q < S::NJ; ++q) {
            if (q >= nq) break;
            mbar_wait(&full[st], ph);
            if (pv_live) {
              __syncwarp();  // wgmma is .aligned: the warp converges first
              const uint32_t vb = smem_u32(ring + st * S::STAGE_BYTES) +
                                  S::LOOP_AT;
              wgmma_fence();
#pragma unroll
              for (int j = 0; j < S::KT; ++j)
                // V MN-major: step j is its rows 16 j .. 16 j + 15.
                Wgmma<FLASH_CHUNK>::template bf16_rs<1>(
                    o[q], px[j], desc_sw(vb + 16 * 128 * j, 128, S::L_SUB));
            }
            next();
          }
        }
        if (t < t1) {
          for (int i = 0; i < c; ++i) {
            mbar_wait(&full[st], ph);
            if (s_live) {
              __syncwarp();
              const uint8_t* stage = ring + st * S::STAGE_BYTES;
              const uint32_t a0 =
                  smem_u32(RES ? qres + i * S::Q_CHUNK : stage) +
                  wg * 64 * 128;
              const uint32_t kb = smem_u32(stage) + S::LOOP_AT;
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < S::KD; ++ks) {
                const uint32_t a = a0 + (ks / 4) * S::Q_SUB + 32 * (ks % 4);
                const uint32_t b = kb + (ks / 4) * S::L_SUB + 32 * (ks % 4);
                Wgmma<TILE>::bf16_ss(x, desc_sw(a, 128), desc_sw(b, 128));
              }
            }
            next();
          }
        }
        if (RES) wgmma_commit();
        if (s_live) read_ids(t * TILE);  // while the products run
        if (RES) {
          wgmma_wait<0>();
          for (int k = 0, s2 = first; k < n; ++k) {
            release(s2);
            if (++s2 == stages) s2 = 0;
          }
        }
        keep_alive(px);
#pragma unroll
        for (int q = 0; q < S::NJ; ++q) fence_operands(o[q]);
        fence_operands(x);
        if (s_live) {
          float alpha[2];
          softmax(t * TILE, alpha);
          rescale(alpha);
#pragma unroll
          for (int j = 0; j < S::KT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              px[j][r] = pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
        }
      }
    } else {
      uint32_t ph2 = 0;
      for (int t = 0; t < t1; ++t) {
        const bool live = t < t_end;  // one value per warpgroup
        if (live) read_ids(t * TILE);
        // -- S = Q K^T over the chunks, in order. ----------------------------
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) x[i] = 0.f;
        for (int i = 0; i < c; ++i) {
          mbar_wait(&full[st], ph);
          if (live) {
            __syncwarp();
            const uint8_t* stage = ring + st * S::STAGE_BYTES;
            tf32_chunk_products<TILE, S::BLOCK, S::KD, 2>(
                x, RES ? qres + i * S::Q_CHUNK : stage,
                smem_u32(stage) + S::LOOP_AT, rloc, tq);
          }
          mbar_arrive(&empty[st]);
          advance();
        }
        // -- The online softmax, then O += P V with V's chunks j0 + q. ------
        if (live) {
          float alpha[2];
          softmax(t * TILE, alpha);
          rescale(alpha);
        }
#pragma unroll
        for (int q = 0; q < S::NJ; ++q) {
          if (q >= nq) break;
          mbar_wait(&full2[q], ph2);
          if (live) {
            __syncwarp();
            tf32_rows_product<FLASH_CHUNK, TILE>(
                o[q], x, smem_u32(part2 + q * S::L_CHUNK));
          }
          mbar_arrive(&empty2[q]);
        }
        ph2 ^= 1;
      }
    }

    T* out = static_cast<T*>(p.o) + bi * p.st_o.b + hi * p.st_o.h +
             FLASH_CHUNK * j0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + rloc + 8 * h;
      if (row >= p.sq) continue;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int q = 0; q < S::NJ; ++q) {
        if (q >= nq) break;
#pragma unroll
        for (int i = 0; i < FLASH_CHUNK / 8; ++i) {
          const int idx = 4 * i + 2 * h, col = FLASH_CHUNK * q + 8 * i + 2 * tq;
          store2(out + (long long)row * p.st_o.s + col, o[q][idx] * inv,
                 o[q][idx + 1] * inv);
        }
      }
      if (tq == 0 && j0 == 0)
        p.lse_out[(long long)bh * p.sq + row] = m[h] + logf(l[h]);
    }
  }
}

template <typename T, bool RES>
int launch_forward_wide(const FlashParams& p, int b, int chunks,
                        cudaStream_t st) {
  using S = WideFwd<T, RES>;
  if (b <= 0 || p.h <= 0 || p.sq <= 0 || p.sk <= 0 || chunks < 2 ||
      hb_wide_fwd(S::BF16, chunks).res != RES)
    return -1;
  const int d = FLASH_CHUNK * chunks;
  CUtensorMap mq, mk = {}, mv = {};
  const bool ok =
      operand_map<T>(&mq, p.q, p.st_q, b, p.h, p.sq, d, S::BLOCK, 128) &&
      (!S::BF16 ||
       (operand_map<T>(&mk, p.k, p.st_k, b, p.h, p.sk, d, S::TILE, 128) &&
        operand_map<T>(&mv, p.v, p.st_v, b, p.h, p.sk, d, S::TILE, 128)));
  if (!ok) return -2;
  auto kernel = flash_forward_wide_kernel<T, RES>;
  const int smem = wide_fwd_smem(S::BF16, chunks);
  // The most any c asks of this instance, allowed once per device.
  static unsigned allowed = 0;
  if (const int err = allow_smem(kernel, HB_SMEM_LIMIT, allowed)) return err;
  const int groups = (chunks + S::NJ - 1) / S::NJ;
  kernel<<<dim3(b * p.h * groups, (p.sq + S::BLOCK - 1) / S::BLOCK),
           S::THREADS, smem, st>>>(mq, mk, mv, p, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Every c of each instance fits: RES bf16 up to c = 4, f32 at c = 2; the
// streaming instances' budget does not depend on c.
static_assert(wide_fwd_smem(true, 2) <= HB_SMEM_LIMIT &&
                  wide_fwd_smem(true, 3) <= HB_SMEM_LIMIT &&
                  wide_fwd_smem(true, 4) <= HB_SMEM_LIMIT &&
                  wide_fwd_smem(true, 5) <= HB_SMEM_LIMIT &&
                  wide_fwd_smem(false, 2) <= HB_SMEM_LIMIT &&
                  wide_fwd_smem(false, 3) <= HB_SMEM_LIMIT,
              "the block's shared memory");

}  // namespace

int flash_forward_wide(const FlashParams& p, int b, int chunks, bool bf16,
                       cudaStream_t st) {
  const bool res = hb_wide_fwd(bf16, chunks).res;
  if (bf16)
    return res ? launch_forward_wide<__nv_bfloat16, true>(p, b, chunks, st)
               : launch_forward_wide<__nv_bfloat16, false>(p, b, chunks, st);
  return res ? launch_forward_wide<float, true>(p, b, chunks, st)
             : launch_forward_wide<float, false>(p, b, chunks, st);
}

}  // namespace fewbit
