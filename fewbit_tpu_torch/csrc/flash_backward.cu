// The entry points of the tensor-core flash backward (F2 and F3,
// flash_backward.cuh) and the head dimension 64's instantiations;
// flash_backward_d<D>.cu hold the other multiples of 16 up to 128,
// flash_backward_wide.cu every multiple of 128 above.
#include "flash_backward.cuh"

FEWBIT_FLASH_BACKWARD_D(64)

namespace fewbit {
namespace {

int launch_backward_d(const FlashParams& p, int b, int d, bool bf16,
                      bool dkv, cudaStream_t st) {
  switch (d) {
    case 16:
      return flash_backward_d16(p, b, bf16, dkv, st);
    case 32:
      return flash_backward_d32(p, b, bf16, dkv, st);
    case 48:
      return flash_backward_d48(p, b, bf16, dkv, st);
    case 64:
      return flash_backward_d64(p, b, bf16, dkv, st);
    case 80:
      return flash_backward_d80(p, b, bf16, dkv, st);
    case 96:
      return flash_backward_d96(p, b, bf16, dkv, st);
    case 112:
      return flash_backward_d112(p, b, bf16, dkv, st);
    case 128:
      return flash_backward_d128(p, b, bf16, dkv, st);
    default:
      if (d > FLASH_CHUNK && d % FLASH_CHUNK == 0)
        return flash_backward_wide(p, b, d / FLASH_CHUNK, bf16, dkv, st);
      return -1;
  }
}

}  // namespace
}  // namespace fewbit

// q and dout (b, h, sq, d), k and v (b, h, sk, d) of f32 or bf16 (is_bf16),
// d a multiple of 16 up to 128 (the wrappers give any other d up to 128
// zero-padded copies) or of 128 above it, any (b, h, s) strides that are multiples of 16 bytes, as the
// base addresses are; seg_q (b, sq) and seg_kv (b, sk) int32 or both
// null; the forward's lse and di = sum(dout * o), (b, h, sq) f32
// contiguous.  strides: the (b, h, s) strides of q, k, v, o, dO, dq, dk, dv
// in elements.  Writes dk and dv.  Returns cudaGetLastError() after the
// launch, -1 for arguments the kernel does not take (another d among
// them), -2 when a TMA descriptor cannot be encoded (nothing launched).
extern "C" int fewbit_flash_backward_dkv(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* lse, const void* dout, const void* di,
    void* dk, void* dv, const void* strides, int b, int h, int sq, int sk,
    int d, int causal, float scale, int is_bf16, void* stream) {
  using namespace fewbit;
  FlashParams p = make_backward_params(q, k, v, seg_q, seg_kv, lse, dout, di,
                                       strides, h, sq, sk, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return launch_backward_d(p, b, d, is_bf16, true,
                           static_cast<cudaStream_t>(stream));
}

// As fewbit_flash_backward_dkv; writes dq.
extern "C" int fewbit_flash_backward_dq(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* lse, const void* dout, const void* di,
    void* dq, const void* strides, int b, int h, int sq, int sk, int d,
    int causal, float scale, int is_bf16, void* stream) {
  using namespace fewbit;
  FlashParams p = make_backward_params(q, k, v, seg_q, seg_kv, lse, dout, di,
                                       strides, h, sq, sk, causal, scale);
  p.dq = dq;
  return launch_backward_d(p, b, d, is_bf16, false,
                           static_cast<cudaStream_t>(stream));
}
