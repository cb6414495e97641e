// The tensor-core flash forward (F1, flash_forward.cuh) at head dimension
// 48, in f32 and bf16: a source of its own, so that it compiles beside the
// others.
#include "flash_forward.cuh"

FEWBIT_FLASH_FORWARD_D(48)
