"""PyTorch / CUDA port of the multi-modal BEV scene-understanding system.

A second package beside the JAX reference `lmsu_tpu`, written in PyTorch
for an NVIDIA H100 (Hopper, sm_90a). Plain tensor work is PyTorch; every
Pallas kernel of the JAX package on a ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc at first use (ops/_cuda.py), with a
plain PyTorch version beside it that CPU tensors take.

The package imports neither jax nor anything of `lmsu_tpu`. Entry points
(`inference.Predictor`, `serving.ServingEngine.from_predictor`, the
trainers, `python -m lmsu_tpu_torch.{serve, train_distill, train_synthetic,
train_fusion_ablation, train_pandaset, evaluate}`) run on CUDA unless asked
for the CPU; `prepare_dataset` and `analyze_distribution` are host tools.

Ported so far: the model with its four fusions and both heads, serving
(Predictor -> ServingEngine -> HTTP), CE and KD training, PandaSet,
synthetic and packed data, and every kernel of the JAX package (ROADMAP.md
lists what is still to port).
"""
