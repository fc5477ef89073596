"""Ops of the PyTorch port: plain PyTorch where the JAX package leaves the
work to XLA, and hand-written CUDA kernels (csrc/) where it wrote Pallas."""
