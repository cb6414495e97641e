"""Kernels, their plain versions, the packed-code layout and the
activation pieces."""
