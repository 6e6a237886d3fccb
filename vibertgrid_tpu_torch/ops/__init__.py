"""Tensor operations of the port; the kernel wrappers take CUDA tensors to
the hand-written kernels and CPU tensors to their plain versions."""
