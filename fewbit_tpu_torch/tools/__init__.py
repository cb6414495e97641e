"""Measurement tools of the port: the CUDA-event timer and the card's
published peaks (:mod:`.timing`), the experiment that times the four
tensor-core schedules of kernel 6 (:mod:`.exp_megakernel`), the
long-sequence rows (:mod:`.bench_longseq`), and the generator of the
builtin LUT archive (:mod:`.quantize_builtins`)."""
