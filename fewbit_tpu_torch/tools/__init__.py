"""Measurement tools of the port: the CUDA-event timer and the card's
published peaks (:mod:`.timing`), and the experiment that times the four
tensor-core schedules of kernel 6 (:mod:`.exp_megakernel`)."""
