"""Model construction, seeded initialisation and parameter accounting.

Counterpart of lmsu_tpu/models/factory.py. Initialisation draws every
parameter from one torch.Generator seeded by the caller, module by module
in the model's order, with the law of the flax initialiser its JAX
counterpart has (utils/weights.py::kernel_table says which):
  * every conv (the depthwise convs, the x4 head's transposed convs, the
    classifier and the gate's 1x1 kernels included): flax's conv_init,
    variance_scaling(2, "fan_out", "truncated_normal");
  * the point MLP's and the pillar net's Conv1d layers (flax nn.Dense):
    lecun_normal, variance_scaling(1, "fan_in", "truncated_normal");
  * biases zero, BatchNorm at identity (scale 1, shift 0, mean 0, var 1).
Each truncated normal has std sqrt(scale / fan) / 0.8796 before its cut at
+-2 stds, the fans computed on the flax kernel's shape (in axis -2, out axis
-1, the rest receptive field: a transposed conv's flax kernel is
[kh, kw, out, in], so its fan_out is kh * kw * in). The two packages draw
different numbers from the same seed (the RNGs differ; the laws are the
same); tests share weights through utils/weights.py instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.models.fusion import CompleteSegmentationModel
from lmsu_tpu_torch.models.layers import InvertedResidual
from lmsu_tpu_torch.ops.ir_fused import check_fused_infer, check_fused_train
from lmsu_tpu_torch.utils.weights import init_kernel, kernel_table

_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)


def _check_supported(config: ModelConfig) -> None:
    if config.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{config.compute_dtype}")


def create_model(config: Optional[ModelConfig] = None, *, seed: int = 0
                 ) -> CompleteSegmentationModel:
    """Build the model on the CPU with weights drawn from `seed` alone (the
    module docstring's laws). torch's own initialisation in the modules'
    constructors runs on a forked RNG and is overwritten, so the global RNG
    is left as it was."""
    config = config or ModelConfig()
    _check_supported(config)
    with torch.random.fork_rng(devices=[]):
        model = CompleteSegmentationModel(config)
    table = kernel_table(config)
    weighted = [(n, m) for n, m in model.named_modules() if isinstance(m, _WEIGHTED)]
    missing = {n for n, _ in weighted} ^ set(table)
    if missing:
        raise AssertionError(f"utils/weights.py::kernel_table does not match this model's "
                             f"weights: {sorted(missing)}")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in weighted:
            init_kernel(m.weight, table[name].init, gen)
            if m.bias is not None:
                m.bias.zero_()
    return model


def check_kernel_shapes(model: nn.Module, device: torch.device, train: bool = True) -> None:
    """Before a model runs on a CUDA device, refuses by name each fused
    InvertedResidual whose widths its kernels do not take: K3 for
    fused_inference, and when the model will train, K9, K12 and K13 for
    fused_train. The plain versions that CPU tensors take have no limits."""
    if torch.device(device).type != "cuda":
        return
    for name, m in model.named_modules():
        if not isinstance(m, InvertedResidual):
            continue
        cin, cout = m.widths
        ce = m.conv[3 if m.has_expand else 0].weight.shape[0]
        if train and m.fused_train:
            check_fused_train(name, cin, ce, m.has_expand, m.stride)
        if m.fused_inference:
            check_fused_infer(name, cin, ce, cout, m.stride)


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (BatchNorm running stats are buffers)."""
    return sum(p.numel() for p in model.parameters())


def get_architecture_summary(model: CompleteSegmentationModel) -> Dict[str, str]:
    """Per-subsystem parameter split (reference: fusion_module.py:265-286),
    with the JAX package's keys and formatting: the fusion's count includes
    the camera FPN."""
    counts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        counts[top] = counts.get(top, 0) + p.numel()
    cfg = model.config
    return {
        "camera_params": f"{counts.get('camera_encoder', 0):,}",
        "lidar_params": f"{counts.get('lidar_encoder', 0):,}",
        "fusion_params": f"{counts.get('fusion', 0) + counts.get('camera_fpn', 0):,}",
        "head_params": f"{counts.get('head', 0):,}",
        "total_params": f"{count_parameters(model):,}",
        "fusion_type": cfg.fusion_type,
        "output_mode": cfg.output_mode,
        "use_multiscale": cfg.camera.return_multiscale,
    }
