"""The plain reference the benchmark compares the port with: plain PyTorch
and NumPy, fp32 with TF32 off, importing nothing of the port or of JAX."""
