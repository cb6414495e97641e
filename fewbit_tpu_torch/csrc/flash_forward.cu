// The entry points of the tensor-core flash forward (F1, flash_forward.cuh)
// and the head dimension 64's instantiations; flash_forward_d<D>.cu hold
// the other multiples of 16 up to 128, flash_forward_wide.cu every
// multiple of 128 above.
#include "flash_forward.cuh"

FEWBIT_FLASH_FORWARD_D(64)

// q (b, h, sq, d), k and v (b, h, sk, d) of f32 or bf16 (is_bf16), d a
// multiple of 16 up to 128 (the wrappers give any other d up to 128
// zero-padded copies) or of 128 above it, any (b, h, s) strides that are multiples of 16 bytes, as the
// base addresses are; seg_q (b, sq) and seg_kv (b, sk) int32 or both null.
// strides: the (b, h, s) strides of q, k, v, o, dO, dq, dk, dv in
// elements.  Writes o (q's shape, its own strides, unit stride along d) and
// lse (b, h, sq) f32 contiguous.  Returns cudaGetLastError() after the
// launch, -1 for arguments the kernel does not take (another d among
// them), -2 when a TMA descriptor cannot be encoded (nothing launched).
extern "C" int fewbit_flash_forward(const void* q, const void* k,
                                    const void* v, const void* seg_q,
                                    const void* seg_kv, void* o, void* lse,
                                    const void* strides, int b, int h,
                                    int sq, int sk, int d, int causal,
                                    float scale, int is_bf16, void* stream) {
  using namespace fewbit;
  FlashParams p =
      make_params(q, k, v, seg_q, seg_kv,
                  static_cast<const long long*>(strides), h, sq, sk, causal,
                  scale);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return flash_forward_d16(p, b, is_bf16, st);
    case 32:
      return flash_forward_d32(p, b, is_bf16, st);
    case 48:
      return flash_forward_d48(p, b, is_bf16, st);
    case 64:
      return flash_forward_d64(p, b, is_bf16, st);
    case 80:
      return flash_forward_d80(p, b, is_bf16, st);
    case 96:
      return flash_forward_d96(p, b, is_bf16, st);
    case 112:
      return flash_forward_d112(p, b, is_bf16, st);
    case 128:
      return flash_forward_d128(p, b, is_bf16, st);
    default:
      if (d > FLASH_CHUNK && d % FLASH_CHUNK == 0)
        return flash_forward_wide(p, b, d / FLASH_CHUNK, is_bf16, st);
      return -1;
  }
}

// Dynamic shared memory of a block of F1 (kernel 0), F2 (1) or F3 (2) at
// the instantiation d (a multiple of 16 up to 128, or of 128 above it: the
// wide kernels) in bf16 or f32: what the host's mirror (_flash_smem in
// ops/kernels.py) must give; -1 for another kernel or d.
extern "C" int fewbit_flash_smem(int kernel, int is_bf16, int d) {
  using namespace fewbit;
  if (d > FLASH_CHUNK && d % FLASH_CHUNK == 0) {
    if (kernel == FLASH_F1) return wide_fwd_smem(is_bf16, d / FLASH_CHUNK);
    return kernel == FLASH_F2 || kernel == FLASH_F3
               ? wide_bwd_smem(is_bf16, kernel == FLASH_F2, d / FLASH_CHUNK)
               : -1;
  }
  if (d < 16 || d > 128 || d % 16) return -1;
  switch (kernel) {
    case FLASH_F1:
      return ff_smem(is_bf16, d);
    case FLASH_F2:
    case FLASH_F3:
      return hb_smem(is_bf16, kernel == FLASH_F2, d);
    default:
      return -1;
  }
}
