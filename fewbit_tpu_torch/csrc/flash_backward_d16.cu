// The tensor-core flash backward (F2 and F3, flash_backward.cuh) at head
// dimension 16, in f32 and bf16: a source of its own, so that it compiles
// beside the others.
#include "flash_backward.cuh"

FEWBIT_FLASH_BACKWARD_D(16)
