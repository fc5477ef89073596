"""PyTorch / CUDA port of the multi-modal BEV scene-understanding system.

A second package beside the JAX reference `lmsu_tpu`, written in PyTorch
for an NVIDIA H100 (Hopper, sm_90a). Plain tensor work is PyTorch; every
Pallas kernel of the JAX package on a ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc at first use (ops/_cuda.py), with a
plain PyTorch version beside it that CPU tensors take.

The package imports neither jax nor anything of `lmsu_tpu`. Entry points
(`inference.Predictor`, `serving.ServingEngine.from_predictor`,
`python -m lmsu_tpu_torch.serve`) run on CUDA unless asked for the CPU.

Ported so far: the serving path (Predictor -> ServingEngine -> HTTP) of the
weighted-fusion model, with the sorted-scatter, fusion-gate and fused
InvertedResidual kernels.
"""
