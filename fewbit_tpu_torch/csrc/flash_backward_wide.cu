// Flash attention's backward on the tensor cores, the dK/dV kernel (F2) and
// the dQ kernel (F3), at every head dimension d = 128 c above 128, as JAX's
// TPU kernels take every multiple of 128 there: one instantiation per type
// and kernel, whose number of chunks c is a launch argument.
//
// Replaces JAX's Pallas TPU library kernels _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/
// flash_attention.py) at those head dimensions; the functions are
// flash_backward.cuh's.
//
// What bounds it on this card: the functions' own work is
// flash_backward.cuh's (4 and 3 products of 2 d operations per unmasked
// pair).  At d = 256 F2's dK and dV alone are d registers a thread on 64
// own rows (over the 255 cap), and the f32 planes of the own rows and of a
// stage exceed the block's 227 KB.  So (flash_hopper.cuh, hb_wide_tiles):
// - A block owns 64 rows of its own side per consumer warpgroup and one
//   chunk of 128 columns of its outputs (dK and dV, or dQ): the grid holds
//   c blocks per row tile, adjacent in x, each with head dimension 128's
//   accumulators.
// - The first products (F2: S^T = K Q^T and dP^T = V dO^T; F3: S = Q K^T
//   and dP = dO V^T) contract over all of d: the chunks of the block's own
//   rows (raw, by TMA) and of the looped tile (TMA in bf16; TF32 hi and lo
//   planes by the producer in f32) come through the ring, one chunk a
//   stage, and accumulate in chunk order 0 .. c - 1, so every block of a
//   row tile holds the same P and dS to the bit.  f32 takes their A
//   fragments from the raw own rows in registers (tf32_chunk_products), as
//   flash_backward.cuh does; bf16 both operands from shared memory.
// - The second products (F2: dV += P^T dO and dK += dS^T Q; F3: dQ += dS K)
//   take the looped tile's chunk of the block's columns from part 2, with
//   the tile's row values (lse, di, segment ids): bf16 one TMA tile per
//   operand read MN-major; f32 the planes of that chunk's stage, written
//   transposed and k-permuted by the producer while the chunk is in the
//   ring (one stage in f32).
// - The cost: each of a row tile's c blocks recomputes the first products
//   over all of d, so F2 does (c + 1) / 2 and F3 (2 c + 1) / 3 times the
//   function's work (1.5 and 5/3 at d = 256), which caps them at 2 / (c + 1)
//   and 3 / (2 c + 1) of their bounds.  The bounds stay the functions' own
//   work.  Nothing is summed across blocks: no atomics, bitwise repeatable.
#include "flash_backward.cuh"

namespace fewbit {
namespace {

template <typename T, bool DKV>
struct BwShape : HbWideShape<T, DKV ? FLASH_F2 : FLASH_F3> {
  using Base = HbWideShape<T, DKV ? FLASH_F2 : FLASH_F3>;
  static constexpr int AUX = 3 * Base::TILE + 4;
  static constexpr int THREADS = Base::CONSUMERS + HB_PRODUCERS;
  static constexpr bool REG_SPLIT = Base::WGS == 2;
};

// F2 (DKV) or F3.  map_r1, map_r2: the block's own operands (K and V in F2,
// Q and dO in F3), boxes of BLOCK rows; map_l1, map_l2: the looped ones (Q
// and dO in F2, K and V in F3), boxes of TILE rows, read by TMA for bf16
// only.  chunks: c; blockIdx.x = (batch x head) c + the block's chunk.
template <typename T, bool DKV>
__global__ void __launch_bounds__(BwShape<T, DKV>::THREADS, 1)
    flash_backward_wide_kernel(const __grid_constant__ CUtensorMap map_r1,
                               const __grid_constant__ CUtensorMap map_r2,
                               const __grid_constant__ CUtensorMap map_l1,
                               const __grid_constant__ CUtensorMap map_l2,
                               FlashParams p, int chunks) {
  using namespace hopper;
  using S = BwShape<T, DKV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* part2 = ring + S::STAGES * S::STAGE_BYTES;
  float* aux = reinterpret_cast<float*>(part2 + S::PART2_BYTES);
  int* ids = reinterpret_cast<int*>(aux) + 2 * S::TILE;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(aux + S::AUX);
  uint64_t* empty1 = full1 + S::STAGES;
  uint64_t* full2 = empty1 + S::STAGES;
  uint64_t* empty2 = full2 + 1;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / chunks, cj = blockIdx.x % chunks;
  const int bi = bh / p.h, hi = bh % p.h;
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
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full1[i], HB_PRODUCERS);
      mbar_init(&empty1[i], S::CONSUMERS);
    }
    mbar_init(full2, HB_PRODUCERS);
    mbar_init(empty2, S::CONSUMERS);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ----------------------------------------------------------------------
    // The producer warpgroup.
    // ----------------------------------------------------------------------
    if constexpr (S::REG_SPLIT) reg_dealloc<40>();
    const int ptid = tid - S::CONSUMERS;
    const Strides& st1 = DKV ? p.st_q : p.st_k;
    const Strides& st2 = DKV ? p.st_do : p.st_v;
    const float* f1 = static_cast<const float*>(DKV ? p.q : p.k) +
                      bi * st1.b + hi * st1.h;
    const float* f2 = static_cast<const float*>(DKV ? p.dout : p.v) +
                      bi * st2.b + hi * st2.h;
    // The chunk at which part 2 is filled: f32 transposes chunk cj's planes
    // while they are in the ring's one stage; bf16 loads its own copy by
    // TMA once the tile's chunks are in flight.
    const int fill2 = S::BF16 ? chunks - 1 : cj;
    int st = 0;
    uint32_t ph = 0, ph2 = 0;
    for (int t = t0; t < t1; ++t) {
      const int l0 = t * S::TILE;
      for (int i = 0; i < chunks; ++i) {
        mbar_wait(&empty1[st], ph ^ 1);
        uint8_t* stage = ring + st * S::STAGE_BYTES;
        uint8_t* lp = stage + 2 * S::OWN_BYTES;  // the looped operands
        const int c0 = FLASH_CHUNK * i;
        if (ptid == 0) {
          mbar_expect_tx(&full1[st], S::BF16 ? S::STAGE_BYTES
                                             : 2 * S::OWN_BYTES);
#pragma unroll
          for (int sub = 0; sub < S::SUB; ++sub) {
            const int cs = c0 + sub * (S::RB / S::ELT);
            tma_load_4d(stage + sub * S::OWN_SUB_BYTES, &map_r1, &full1[st],
                        cs, row0, hi, bi);
            tma_load_4d(stage + S::OWN_BYTES + sub * S::OWN_SUB_BYTES,
                        &map_r2, &full1[st], cs, row0, hi, bi);
            if constexpr (S::BF16) {
              tma_load_4d(lp + sub * S::TILE_SUB_BYTES, &map_l1, &full1[st],
                          cs, l0, hi, bi);
              tma_load_4d(lp + S::TILE_BYTES + sub * S::TILE_SUB_BYTES,
                          &map_l2, &full1[st], cs, l0, hi, bi);
            }
          }
        }
        if constexpr (!S::BF16) {
          fetch_tile<S::TILE, FLASH_CHUNK, S::RB>(lp, f1 + c0, st1.s, l0,
                                                  n_loop, ptid);
          fetch_tile<S::TILE, FLASH_CHUNK, S::RB>(lp + S::LOOP_BYTES,
                                                  f2 + c0, st2.s, l0, n_loop,
                                                  ptid);
          asm volatile("cp.async.wait_all;" ::: "memory");
          split_fetched<S::TILE, FLASH_CHUNK, S::RB>(lp, ptid);
          split_fetched<S::TILE, FLASH_CHUNK, S::RB>(lp + S::LOOP_BYTES,
                                                     ptid);
          fence_proxy_async();  // the stores, before wgmma reads them
        }
        mbar_arrive(&full1[st]);
        if (i == fill2) {
          // Part 2, once the consumers are done with the last tile's: the
          // second products' chunk cj and the tile's row values.
          if constexpr (!S::BF16) bar_sync(1, HB_PRODUCERS);  // all split
          mbar_wait(empty2, ph2 ^ 1);
          if constexpr (S::BF16) {
            if (ptid == 0) {
              mbar_expect_tx(full2, S::PART2_BYTES);
#pragma unroll
              for (int sub = 0; sub < S::SUB; ++sub) {
                const int cs = FLASH_CHUNK * cj + sub * (S::RB / S::ELT);
                tma_load_4d(part2 + sub * S::TILE_SUB_BYTES, &map_l1, full2,
                            cs, l0, hi, bi);
                if constexpr (DKV)
                  tma_load_4d(part2 + S::TILE_BYTES + sub * S::TILE_SUB_BYTES,
                              &map_l2, full2, cs, l0, hi, bi);
              }
            }
          } else {
            transpose_planes<S::TILE, FLASH_CHUNK, S::RB>(part2, lp, ptid);
            if constexpr (DKV)
              transpose_planes<S::TILE, FLASH_CHUNK, S::RB>(
                  part2 + S::LOOP_BYTES, lp + S::LOOP_BYTES, ptid);
            fence_proxy_async();
          }
          if (ptid < S::TILE) {  // the tile's row values
            const int row = l0 + ptid;
            const bool in = row < n_loop;
            if (DKV) {
              aux[ptid] = in ? lse[row] : 0.f;
              aux[S::TILE + ptid] = in ? di[row] : 0.f;
            }
            const int id = seg_loop != nullptr && in
                               ? seg_loop[(long long)bi * n_loop + row]
                               : 0;
            ids[ptid] = id;
            const int first = __shfl_sync(0xffffffffu, id, 0);
            const int same = __all_sync(0xffffffffu, id == first);
            if (ptid % 32 == 0) {
              ids[S::TILE + 2 * (ptid / 32)] = same;
              ids[S::TILE + 2 * (ptid / 32) + 1] = first;
            }
          }
          mbar_arrive(full2);
          ph2 ^= 1;
          // No warp copies the next chunk over planes that a slower one is
          // still transposing.
          if constexpr (!S::BF16) bar_sync(1, HB_PRODUCERS);
        }
        if (++st == S::STAGES) {
          st = 0;
          ph ^= 1;
        }
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
    // da: dK (F2) or dQ (F3) without sm_scale; db: dV (F2); chunk cj's.
    constexpr int NA = FLASH_CHUNK / 2;
    float da[NA], db[DKV ? NA : 1];
#pragma unroll
    for (int i = 0; i < NA; ++i) da[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKV ? NA : 1); ++i) db[i] = 0.f;

    int st = 0;
    uint32_t ph = 0, ph2 = 0;
    for (int t = t0; t < t1; ++t) {
      const int l0 = t * S::TILE;
      // S and dP (F2: transposed), then P and dS.
      float x[S::TILE / 2], y[S::TILE / 2];
#pragma unroll
      for (int i = 0; i < S::TILE / 2; ++i) x[i] = y[i] = 0.f;
      // -- The first products: x = R1 L1^T, y = R2 L2^T over the chunks,
      // in order. ------------------------------------------------------------
      for (int i = 0; i < chunks; ++i) {
        mbar_wait(&full1[st], ph);
        __syncwarp();  // wgmma is .aligned: the warp converges first
        const uint8_t* stage = ring + st * S::STAGE_BYTES;
        const uint32_t lb = smem_u32(stage) + 2 * S::OWN_BYTES;
        if constexpr (S::BF16) {
          const uint32_t a1 = smem_u32(stage) + wg * 64 * S::RB;
          fence_operands(x);
          fence_operands(y);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < S::KD; ++ks) {
            const uint32_t a = a1 + (ks / S::KSUB) * S::OWN_SUB_BYTES +
                               32 * (ks % S::KSUB);
            const uint32_t b = lb + (ks / S::KSUB) * S::TILE_SUB_BYTES +
                               32 * (ks % S::KSUB);
            Wgmma<S::TILE>::bf16_ss(x, desc_sw(a, S::RB), desc_sw(b, S::RB));
            Wgmma<S::TILE>::bf16_ss(y, desc_sw(a + S::OWN_BYTES, S::RB),
                                    desc_sw(b + S::TILE_BYTES, S::RB));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(x);
          fence_operands(y);
        } else {
          // F2 holds dK and dV besides: one k step's fragments at a time.
          tf32_chunk_products<S::TILE, S::BLOCK, DKV ? 1 : 2, true>(
              x, y, stage, lb, rloc, tq);
        }
        mbar_arrive(&empty1[st]);
        if (++st == S::STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      mbar_wait(full2, ph2);
      __syncwarp();
      // -- Between the products: x = P, y = dS, as flash_backward.cuh. ------
      const int wrow0 = row0 + 64 * wg;
      const bool diagonal =
          p.causal && (DKV ? wrow0 + 63 > l0 : l0 + S::TILE - 1 > wrow0);
      bool by_segment = seg_loop != nullptr;
      if (by_segment) by_segment = !one_segment<S::TILE>(ids + S::TILE, rid);
      const bool masked = by_segment || diagonal || l0 + S::TILE > n_loop;
      auto between = [&](auto masked_c) {
        constexpr bool MASKED = decltype(masked_c)::value;
#pragma unroll
        for (int i = 0; i < S::TILE / 8; ++i) {
          const int col = 8 * i + 2 * tq;
          float2 lse2 = make_float2(0.f, 0.f), di2 = lse2;
          int2 id2 = make_int2(0, 0);
          if (DKV) {
            lse2 = *reinterpret_cast<const float2*>(aux + col);
            di2 = *reinterpret_cast<const float2*>(aux + S::TILE + col);
          }
          if (MASKED) id2 = *reinterpret_cast<const int2*>(ids + col);
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
                pv = colg < n_loop ? exp2f((val - lse_v) * LOG2E) : 0.f;
              } else {
                pv = exp2f(fmaf(x[idx], scale_log2, -LOG2E * lse_v));
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
      // -- The second products: da += y L1_cj, db += x L2_cj over the
      // tile's rows, x and y from registers. ----------------------------
      const uint32_t b2 = smem_u32(part2);
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
            Wgmma<FLASH_CHUNK>::template bf16_rs<1>(
                db, px[j],
                desc_sw(b2 + S::TILE_BYTES + off, S::RB, S::MN_LBO));
          Wgmma<FLASH_CHUNK>::template bf16_rs<1>(
              da, py[j], desc_sw(b2 + off, S::RB, S::MN_LBO));
        }
        wgmma_commit();
        wgmma_wait<0>();
        if (DKV) keep_alive(px);
        keep_alive(py);
        fence_operands(da);
        fence_operands(db);
      } else {
        // One product at a time: its fragment registers are free again
        // before the next one's are made.
        if constexpr (DKV)
          tf32_rows_product<FLASH_CHUNK, S::TILE>(db, x, b2 + S::LOOP_BYTES);
        tf32_rows_product<FLASH_CHUNK, S::TILE>(da, y, b2);
      }
      mbar_arrive(empty2);
      ph2 ^= 1;
    }

    const Strides& sta = DKV ? p.st_dk : p.st_dq;
    T* out_a = static_cast<T*>(DKV ? p.dk : p.dq) + bi * sta.b + hi * sta.h +
               FLASH_CHUNK * cj;
    T* out_b = static_cast<T*>(p.dv) + bi * p.st_dv.b + hi * p.st_dv.h +
               FLASH_CHUNK * cj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rloc + 8 * h;
      if (row >= n_res) continue;
#pragma unroll
      for (int i = 0; i < FLASH_CHUNK / 8; ++i) {
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

template <typename T, bool DKV>
int launch_backward_wide(const FlashParams& p, int b, int chunks,
                         cudaStream_t st) {
  using S = BwShape<T, DKV>;
  if (b <= 0 || p.h <= 0 || p.sq <= 0 || p.sk <= 0 || chunks < 2) return -1;
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
      operand_map<T>(&r1, own1, so1, b, p.h, own, d, S::BLOCK, S::RB) &&
      operand_map<T>(&r2, own2, so2, b, p.h, own, d, S::BLOCK, S::RB) &&
      (!S::BF16 ||
       (operand_map<T>(&l1, loop1, sl1, b, p.h, loop, d, S::TILE, S::RB) &&
        operand_map<T>(&l2, loop2, sl2, b, p.h, loop, d, S::TILE, S::RB)));
  if (!ok) return -2;
  auto kernel = flash_backward_wide_kernel<T, DKV>;
  constexpr int smem = wide_smem(DKV ? FLASH_F2 : FLASH_F3, S::BF16);
  static_assert(smem <= HB_SMEM_LIMIT, "the block's shared memory");
  static unsigned allowed = 0;
  if (const int err = allow_smem(kernel, smem, allowed)) return err;
  kernel<<<dim3(b * p.h * chunks, (own + S::BLOCK - 1) / S::BLOCK),
           S::THREADS, smem, st>>>(r1, r2, l1, l2, p, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_backward_wide(const FlashParams& p, int b, int chunks, bool bf16,
                        bool dkv, cudaStream_t st) {
  if (dkv)
    return bf16 ? launch_backward_wide<__nv_bfloat16, true>(p, b, chunks, st)
                : launch_backward_wide<float, true>(p, b, chunks, st);
  return bf16 ? launch_backward_wide<__nv_bfloat16, false>(p, b, chunks, st)
              : launch_backward_wide<float, false>(p, b, chunks, st);
}

}  // namespace fewbit
