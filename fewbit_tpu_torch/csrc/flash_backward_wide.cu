// The wide F2 and F3 (flash_backward_wide.cuh) in f32, and the launcher of
// both types that flash_backward.cu's entry points call at every head
// dimension d = 128 c above 128 (the bf16 instances build in
// flash_backward_wide_bf16.cu).
#include "flash_backward_wide.cuh"

namespace fewbit {

int flash_backward_wide(const FlashParams& p, int b, int chunks, bool bf16,
                        bool dkv, cudaStream_t st) {
  if (bf16) return flash_backward_wide_bf16(p, b, chunks, dkv, st);
  return dkv ? launch_backward_wide<float, true, false>(p, b, chunks, st)
             : launch_backward_wide<float, false, false>(p, b, chunks, st);
}

}  // namespace fewbit
