"""PyTorch / CUDA port of the multi-modal BEV scene-understanding system.

A second package beside the JAX reference `lmsu_tpu`, written in PyTorch
for an NVIDIA H100 (Hopper, sm_90a). Plain tensor work is PyTorch; every
Pallas kernel of the JAX package on a ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc at first use (ops/_cuda.py), with a
plain PyTorch version beside it that CPU tensors take.

The package imports neither jax nor anything of `lmsu_tpu`. Entry points
(`inference.Predictor`, `serving.ServingEngine.from_predictor`, the
trainers, `python -m lmsu_tpu_torch.{serve, train_distill, train_synthetic,
train_fusion_ablation, train_pandaset, evaluate, run_multiprocess}`) run on
CUDA unless asked for the CPU, as do `analyze_weighted_gate`,
`visualize_predictions`, the experiments
(`python -m lmsu_tpu_torch.experiments.<name>`, experiments/) and the
benches (`bench_serving`, `bench_frozen_predictor`, `bench_input_pipeline`,
`dress_rehearsal`); `prepare_dataset`, `analyze_distribution`,
`plot_training_curves`, `create_architecture_diagram` and
`summarize_experiments` are host tools. The tools, experiments and benches
write their default outputs under one root of the port's own
(common.OUTPUT_ROOT, torch_runs/).

Ported: the model with its four fusions and both heads, serving
(Predictor -> ServingEngine -> HTTP), CE and KD training, PandaSet,
synthetic and packed data, data parallelism (parallel/: one process a
device, the fsdp teacher, data-parallel serving, the model axis),
profiling (utils/profiling.py), every experiment, the report, the benches,
the host tools and every kernel of the JAX package; the TPU and XLA probes
of scripts/ stay unported (ROADMAP.md).
"""
