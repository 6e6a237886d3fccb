"""PyTorch/CUDA port of vibertgrid_tpu for one NVIDIA H100.

The ViBERTgrid model with the simplified head, for inference and for
training (dropout, losses, optimizers, train step), with its attention,
fused FFN and BERTgrid scatter, forward and backward, as hand-written
Hopper kernels (``csrc/*.cu``). CUDA tensors take the kernels, CPU tensors
their plain PyTorch versions.
"""
