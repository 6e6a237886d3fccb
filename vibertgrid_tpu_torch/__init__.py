"""PyTorch/CUDA port of vibertgrid_tpu for one NVIDIA H100.

The inference forward of the ViBERTgrid model, with its attention, fused
FFN and BERTgrid scatter as hand-written Hopper kernels
(``csrc/*.cu``). CUDA tensors take the kernels, CPU tensors their plain
PyTorch versions.
"""
