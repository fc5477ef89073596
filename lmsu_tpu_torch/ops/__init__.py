"""Ops of the PyTorch port: plain PyTorch where the JAX package leaves the
work to XLA, and hand-written CUDA kernels (csrc/) where it wrote Pallas.

Importing the package registers the serving kernels' operators
(lmsu_tpu_torch::segment_max, segment_max_flat, scatter_max, fusion_gate,
fused_ir_infer; ops/_cuda.py::define_op), which a loaded export artifact
calls."""

from lmsu_tpu_torch.ops import fusion_gate, ir_fused, scatter_sorted, voxelize  # noqa: F401
