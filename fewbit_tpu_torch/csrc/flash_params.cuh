// What the flash attention sources share: the parameters of a launch, as the
// entry points fill them from their C arguments, and the mask value.
#pragma once

#include "common.cuh"

namespace fewbit {

// The library's DEFAULT_MASK_VALUE, rounded from the double product as
// Python rounds it.
constexpr float MASK_VALUE =
    static_cast<float>(-0.7 * 3.40282346638528859812e+38);

struct Strides {
  long long b, h, s;  // in elements; the stride along d is 1
};

struct FlashParams {
  const void *q, *k, *v, *dout;
  const int *seg_q, *seg_kv;
  const float *lse_in, *di;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  Strides st_q, st_k, st_v, st_o, st_do, st_dq, st_dk, st_dv;
  int h, sq, sk, causal;
  float scale;
};

// Fills the parameters shared by the entry points.  strides holds (b, h, s)
// strides of q, k, v, o, dO, dq, dk, dv in that order (24 values, host
// memory; 0 for a tensor a kernel does not take).
inline FlashParams make_params(const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_kv,
                               const long long* strides, int h, int sq,
                               int sk, int causal, float scale) {
  FlashParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  Strides* st[8] = {&p.st_q,  &p.st_k,  &p.st_v,  &p.st_o,
                    &p.st_do, &p.st_dq, &p.st_dk, &p.st_dv};
  for (int t = 0; t < 8; ++t)
    *st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

// The parameters of a backward launch, from the arguments the two backward
// entry points share.
inline FlashParams make_backward_params(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* lse, const void* dout, const void* di,
    const void* strides, int h, int sq, int sk, int causal, float scale) {
  FlashParams p =
      make_params(q, k, v, seg_q, seg_kv,
                  static_cast<const long long*>(strides), h, sq, sk, causal,
                  scale);
  p.lse_in = static_cast<const float*>(lse);
  p.dout = dout;
  p.di = static_cast<const float*>(di);
  return p;
}

}  // namespace fewbit
