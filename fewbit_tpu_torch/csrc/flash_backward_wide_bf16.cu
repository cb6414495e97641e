// The wide F2 and F3 (flash_backward_wide.cuh) in bf16: at c = 2 chunks
// with the block's own rows resident, above with them streamed.
#include "flash_backward_wide.cuh"

namespace fewbit {

int flash_backward_wide_bf16(const FlashParams& p, int b, int chunks,
                             bool dkv, cudaStream_t st) {
  using T = __nv_bfloat16;
  if (chunks == 2)
    return dkv ? launch_backward_wide<T, true, true>(p, b, chunks, st)
               : launch_backward_wide<T, false, true>(p, b, chunks, st);
  return dkv ? launch_backward_wide<T, true, false>(p, b, chunks, st)
             : launch_backward_wide<T, false, false>(p, b, chunks, st);
}

}  // namespace fewbit
