"""PyTorch/CUDA port of vibertgrid_tpu for one NVIDIA H100.

The ViBERTgrid model with its three field-type heads (simplified, full,
CRF), for inference and for training (dropout, losses, optimizers, train
step, checkpoints), with its attention, fused FFN, fused attention epilogue
and BERTgrid scatter as hand-written Hopper kernels (``csrc/*.cu``). CUDA
tensors take the kernels, CPU tensors their plain PyTorch versions.
"""
