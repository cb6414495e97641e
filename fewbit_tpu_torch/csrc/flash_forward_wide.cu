// Flash attention's forward on the tensor cores (F1) at every head
// dimension d = 128 c above 128, as JAX's TPU kernel takes every multiple of
// 128 there: one instantiation per type, whose number of chunks c is a
// launch argument.
//
// Replaces JAX's Pallas TPU library kernel _flash_attention_impl
// (jax/experimental/pallas/ops/tpu/flash_attention.py) at those head
// dimensions; the function is flash_forward.cuh's.
//
// What bounds it on this card: the function's own work is flash_forward.cuh's
// (2 products of 2 d operations per unmasked pair).  At d = 256 in f32 the
// TF32 planes of a block's 64 query rows (128 KB) and a 32-row stage of K
// and V (128 KB) exceed the block's 227 KB, and a thread's d / 2 registers
// of o (128) do not fit beside S and P.  So (flash_hopper.cuh,
// hb_wide_tiles):
// - A block owns 64 query rows per consumer warpgroup and one chunk of 128
//   columns of o: the grid holds c blocks per row tile (adjacent in x, so
//   they share the L2's copies of q and k), each with head dimension 128's
//   o[64] a thread.
// - S = Q K^T contracts over all of d: the chunks of the block's Q rows and
//   of the kv tile's K come through the ring, one chunk a stage (Q by TMA;
//   K by TMA in bf16, split into TF32 planes by the producer in f32), and
//   accumulate into one fragment in chunk order 0 .. c - 1.  Every block of
//   a row tile so holds the same S to the bit, and computes m, l and lse
//   with the same arithmetic: the chunks of o agree, and only chunk 0
//   writes lse.  Nothing is summed across blocks.
// - f32: S's A operand from registers, each k step's TF32 hi and lo split
//   from the raw Q rows in the stage (tf32_chunk_products).  bf16: both
//   operands of S from shared memory.
// - V's chunk of the block's columns and the kv tile's segment ids go
//   through part 2, filled once the consumers are done with the last tile's
//   (bf16: one TMA tile read MN-major; f32: split and written transposed
//   and k-permuted as flash_forward.cuh's), then O += P V as at d = 128.
// - The cost: each of a row tile's c blocks computes S over all of d for
//   its 128 columns of o, so F1 does (c + 1) / 2 times the function's work
//   (1.5 times at d = 256), which caps it at 2 / (c + 1) of the bound.  Its
//   bound stays the function's own work.
#include "flash_forward.cuh"

namespace fewbit {
namespace {

template <typename T>
struct FwShape : HbWideShape<T> {
  using Base = HbWideShape<T>;
  static constexpr int PRODUCERS = Base::BF16 ? 32 : HB_PRODUCERS;
  static constexpr int THREADS = Base::CONSUMERS + PRODUCERS;
  static constexpr int AUX = Base::TILE + 4;
};

// map_q: boxes of BLOCK query rows; map_k, map_v: boxes of TILE kv rows,
// read by TMA for bf16 only.  chunks: c, the head dimension's 128-column
// chunks; blockIdx.x = (batch x head) c + the block's chunk.
template <typename T>
__global__ void __launch_bounds__(FwShape<T>::THREADS, 1)
    flash_forward_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              FlashParams p, int chunks) {
  using namespace hopper;
  using S = FwShape<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* part2 = ring + S::STAGES * S::STAGE_BYTES;
  uint8_t* staging = part2 + S::PART2_BYTES;
  int* aux =
      reinterpret_cast<int*>(staging + (S::BF16 ? 0 : 2 * S::TILE_BYTES));
  uint64_t* full = reinterpret_cast<uint64_t*>(aux + S::AUX);
  uint64_t* empty = full + S::STAGES;
  uint64_t* full2 = empty + S::STAGES;
  uint64_t* empty2 = full2 + 1;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / chunks, cj = blockIdx.x % chunks;
  const int bi = bh / p.h, hi = bh % p.h;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * S::BLOCK;
  int t1 = (p.sk + S::TILE - 1) / S::TILE;
  if (p.causal) t1 = min(t1, (min(row0 + S::BLOCK, p.sq) - 1) / S::TILE + 1);

  if (tid == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], S::PRODUCERS);
      mbar_init(&empty[i], S::CONSUMERS);
    }
    mbar_init(full2, S::PRODUCERS);
    mbar_init(empty2, S::CONSUMERS);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ----------------------------------------------------------------------
    // The producer: a warp (bf16) or a warpgroup (f32).
    // ----------------------------------------------------------------------
    const int ptid = tid - S::CONSUMERS;
    const float* kf = static_cast<const float*>(p.k) + bi * p.st_k.b +
                      hi * p.st_k.h;
    const float* vf = static_cast<const float*>(p.v) + bi * p.st_v.b +
                      hi * p.st_v.h;
    int st = 0;
    uint32_t ph = 0, ph2 = 0;
    for (int t = 0; t < t1; ++t) {
      const int l0 = t * S::TILE;
      for (int i = 0; i < chunks; ++i) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* stage = ring + st * S::STAGE_BYTES;
        uint8_t* kst = stage + S::OWN_BYTES;
        const int c0 = FLASH_CHUNK * i;
        if (ptid == 0) {
          mbar_expect_tx(&full[st],
                         S::BF16 ? S::STAGE_BYTES : S::OWN_BYTES);
#pragma unroll
          for (int sub = 0; sub < S::SUB; ++sub) {
            const int cs = c0 + sub * (S::RB / S::ELT);
            tma_load_4d(stage + sub * S::OWN_SUB_BYTES, &map_q, &full[st],
                        cs, row0, hi, bi);
            if constexpr (S::BF16)
              tma_load_4d(kst + sub * S::TILE_SUB_BYTES, &map_k, &full[st],
                          cs, l0, hi, bi);
          }
        }
        if constexpr (!S::BF16) {
          fetch_tile<S::TILE, FLASH_CHUNK, S::RB>(kst, kf + c0, p.st_k.s, l0,
                                                  p.sk, ptid);
          asm volatile("cp.async.wait_all;" ::: "memory");
          split_fetched<S::TILE, FLASH_CHUNK, S::RB>(kst, ptid);
          fence_proxy_async();  // the stores, before wgmma reads them
        }
        mbar_arrive(&full[st]);
        if (++st == S::STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      // Part 2: V's chunk cj and the tile's ids, once the consumers are
      // done with the last tile's.  f32 copies V into the staging planes
      // first (only this warpgroup reads them).
      const int cv = FLASH_CHUNK * cj;
      if constexpr (!S::BF16)
        fetch_tile<S::TILE, FLASH_CHUNK, S::RB>(staging, vf + cv, p.st_v.s,
                                                l0, p.sk, ptid);
      mbar_wait(empty2, ph2 ^ 1);
      if constexpr (S::BF16) {
        if (ptid == 0) {
          mbar_expect_tx(full2, S::TILE_BYTES);
#pragma unroll
          for (int sub = 0; sub < S::SUB; ++sub)
            tma_load_4d(part2 + sub * S::TILE_SUB_BYTES, &map_v, full2,
                        cv + sub * (S::RB / S::ELT), l0, hi, bi);
        }
      }
      if (p.seg_kv != nullptr) {
        // The tile's ids in halves of 32, a warp each: one id in all of a
        // half's?
        for (int half = ptid / 32; half < S::TILE / 32;
             half += S::PRODUCERS / 32) {
          const int r = 32 * half + ptid % 32, row = l0 + r;
          const int id =
              row < p.sk ? p.seg_kv[(long long)bi * p.sk + row] : 0;
          aux[r] = id;
          const int first = __shfl_sync(0xffffffffu, id, 0);
          const int same = __all_sync(0xffffffffu, id == first);
          if (ptid % 32 == 0) {
            aux[S::TILE + 2 * half] = same;
            aux[S::TILE + 2 * half + 1] = first;
          }
        }
      }
      if constexpr (!S::BF16) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        split_fetched<S::TILE, FLASH_CHUNK, S::RB>(staging, ptid);
        // Every warp's V chunks are split before any warp transposes them.
        bar_sync(1, HB_PRODUCERS);
        transpose_planes<S::TILE, FLASH_CHUNK, S::RB>(part2, staging, ptid);
        fence_proxy_async();
      }
      mbar_arrive(full2);
      ph2 ^= 1;
      // No warp copies the next tile's V into the staging planes while a
      // slower one still transposes them.
      if constexpr (!S::BF16) bar_sync(1, HB_PRODUCERS);
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
    float o[FLASH_CHUNK / 2];
#pragma unroll
    for (int i = 0; i < FLASH_CHUNK / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float x[S::TILE / 2];  // S, then P

    // The online softmax of the tile at l0, as flash_forward.cuh's.
    auto softmax = [&](int l0, float (&alpha)[2]) {
      bool by_segment = p.seg_q != nullptr;
      if (by_segment) by_segment = !one_segment<S::TILE>(aux + S::TILE, rid);
      const bool diagonal = p.causal && l0 + S::TILE - 1 > wrow0;
      const bool masked = by_segment || diagonal || l0 + S::TILE > p.sk ||
                          !(p.scale > 0.f);
      float mx[2] = {m[0], m[1]};
      auto run = [&](auto masked_c) {
        constexpr bool MASKED = decltype(masked_c)::value;
        if (MASKED) {
#pragma unroll
          for (int i = 0; i < S::TILE / 8; ++i) {
            const int col = 8 * i + 2 * tq;
            const int2 id2 = by_segment
                                 ? *reinterpret_cast<const int2*>(aux + col)
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
        for (int idx = 0; idx < S::TILE / 2; ++idx) {
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
    // warpgroup's rows: it only frees their stages and part 2.
    const int t_end = p.causal ? min(t1, (wrow0 + 63) / S::TILE + 1) : t1;
    int st = 0;
    uint32_t ph = 0, ph2 = 0;
    for (int t = 0; t < t1; ++t) {
      const bool live = t < t_end;  // one value per warpgroup
      // -- S = Q K^T over the chunks, in order. ----------------------------
#pragma unroll
      for (int i = 0; i < S::TILE / 2; ++i) x[i] = 0.f;
      for (int i = 0; i < chunks; ++i) {
        mbar_wait(&full[st], ph);
        if (live) {
          __syncwarp();  // wgmma is .aligned: the warp converges first
          const uint8_t* stage = ring + st * S::STAGE_BYTES;
          const uint32_t kb = smem_u32(stage) + S::OWN_BYTES;
          if constexpr (S::BF16) {
            const uint32_t a0 = smem_u32(stage) + wg * 64 * S::RB;
            fence_operands(x);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < S::KD; ++ks) {
              const uint32_t a = a0 + (ks / S::KSUB) * S::OWN_SUB_BYTES +
                                 32 * (ks % S::KSUB);
              const uint32_t b = kb + (ks / S::KSUB) * S::TILE_SUB_BYTES +
                                 32 * (ks % S::KSUB);
              Wgmma<S::TILE>::bf16_ss(x, desc_sw(a, S::RB),
                                      desc_sw(b, S::RB));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_operands(x);
          } else {
            tf32_chunk_products<S::TILE, S::BLOCK, S::KD, 2>(x, stage, kb,
                                                             rloc, tq);
          }
        }
        mbar_arrive(&empty[st]);
        if (++st == S::STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      // -- The online softmax, then O += P V with V's chunk cj. -------------
      mbar_wait(full2, ph2);
      if (live) {
        __syncwarp();
        float alpha[2];
        softmax(t * S::TILE, alpha);
        if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
          for (int idx = 0; idx < FLASH_CHUNK / 2; ++idx)
            o[idx] *= alpha[(idx >> 1) & 1];
        }
        const uint32_t vb = smem_u32(part2);
        if constexpr (S::BF16) {
          uint32_t px[S::KT][4];
#pragma unroll
          for (int j = 0; j < S::KT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              px[j][r] = pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
          fence_operands(o);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < S::KT; ++j)
            Wgmma<FLASH_CHUNK>::template bf16_rs<1>(
                o, px[j], desc_sw(vb + 16 * S::RB * j, S::RB, S::MN_LBO));
          wgmma_commit();
          wgmma_wait<0>();
          keep_alive(px);
          fence_operands(o);
        } else {
          tf32_rows_product<FLASH_CHUNK, S::TILE>(o, x, vb);
        }
      }
      mbar_arrive(empty2);
      ph2 ^= 1;
    }

    T* out = static_cast<T*>(p.o) + bi * p.st_o.b + hi * p.st_o.h +
             FLASH_CHUNK * cj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + rloc + 8 * h;
      if (row >= p.sq) continue;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int i = 0; i < FLASH_CHUNK / 8; ++i) {
        const int idx = 4 * i + 2 * h, col = 8 * i + 2 * tq;
        store2(out + (long long)row * p.st_o.s + col, o[idx] * inv,
               o[idx + 1] * inv);
      }
      if (tq == 0 && cj == 0)
        p.lse_out[(long long)bh * p.sq + row] = m[h] + logf(l[h]);
    }
  }
}

template <typename T>
int launch_forward_wide(const FlashParams& p, int b, int chunks,
                        cudaStream_t st) {
  using S = FwShape<T>;
  if (b <= 0 || p.h <= 0 || p.sq <= 0 || p.sk <= 0 || chunks < 2) return -1;
  const int d = FLASH_CHUNK * chunks;
  CUtensorMap mq, mk = {}, mv = {};
  const bool ok =
      operand_map<T>(&mq, p.q, p.st_q, b, p.h, p.sq, d, S::BLOCK, S::RB) &&
      (!S::BF16 ||
       (operand_map<T>(&mk, p.k, p.st_k, b, p.h, p.sk, d, S::TILE, S::RB) &&
        operand_map<T>(&mv, p.v, p.st_v, b, p.h, p.sk, d, S::TILE, S::RB)));
  if (!ok) return -2;
  auto kernel = flash_forward_wide_kernel<T>;
  constexpr int smem = wide_smem(S::BF16);
  static_assert(smem <= HB_SMEM_LIMIT, "the block's shared memory");
  static unsigned allowed = 0;
  if (const int err = allow_smem(kernel, smem, allowed)) return err;
  kernel<<<dim3(b * p.h * chunks, (p.sq + S::BLOCK - 1) / S::BLOCK),
           S::THREADS, smem, st>>>(mq, mk, mv, p, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_forward_wide(const FlashParams& p, int b, int chunks, bool bf16,
                       cudaStream_t st) {
  return bf16 ? launch_forward_wide<__nv_bfloat16>(p, b, chunks, st)
              : launch_forward_wide<float>(p, b, chunks, st);
}

}  // namespace fewbit
