"""Why does weighted fusion trail concat and minimal on the hard benchmark?
Causal ablation and statistics of a trained weighted-fusion model's gate.

Counterpart of scripts/analyze_weighted_gate.py. The gate's output layer is
the 1x1 conv `fusion.attention.2` (models/fusion.py::WeightedFusion), so
editing its weights in the state dict replaces the gate without touching
model code:
  * uniform     weight 0, bias 0          -> softmax(0, 0) = exactly (0.5, 0.5);
  * camera_only weight 0, bias (+20, -20) -> weights ~(1, 0);
  * lidar_only  weight 0, bias (-20, +20) -> weights ~(0, 1).
Each variant's val mIoU beside the trained gate's isolates what the learned
gate contributes. The gate statistics on val batches (weight distribution,
decisiveness, per-sample spatial spread, correlation of the camera weight
with BEV occupancy) are recomputed in float64 numpy from the two fusion
projections, which forward hooks on `fusion.cam_proj` / `fusion.lidar_proj`
capture (the JAX script's capture_intermediates).

With --use-pallas-fusion the variants run through the fused gate kernel
(ops/fusion_gate.py), the edited ones with a softmax saturated at +-20.

Usage:
  python -m lmsu_tpu_torch.analyze_weighted_gate --checkpoint <run>/best.pth \\
      [--device cuda] [--use-pallas-fusion] [--stat-batches 4] [--output-root torch_runs]

The checkpoint is a torch file of the port's trainers or a JAX-package
flax checkpoint (told by content). The default checkpoint and output sit
under --output-root (torch_runs/checkpoints/quant_accuracy/best.pth,
torch_runs/docs/weighted_gate_analysis.json), never over the JAX package's
tracked docs/weighted_gate_analysis.json. Raises without a GPU unless
given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from lmsu_tpu_torch.common import (add_common_args, add_output_root_arg, apply_overrides,
                                   build_loaders)
from lmsu_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from lmsu_tpu_torch.data.rasterize import bev_cell_key
from lmsu_tpu_torch.ops.metrics import SegmentationMetrics

GATE_KINDS = ("trained", "uniform", "camera_only", "lidar_only")
#: The gate's output layer: a 1x1 conv from C channels to the 2 gate logits.
GATE_OUT = "fusion.attention.2"
_GATE_BIAS = {"uniform": (0.0, 0.0), "camera_only": (20.0, -20.0),
              "lidar_only": (-20.0, 20.0)}


def _regime(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128),
        data=DataConfig(dataset="synthetic", synthetic_difficulty="hard",
                        synthetic_num_train=400, synthetic_num_val=512, batch_size=32),
        train=TrainConfig(class_weights=(0.4, 3.5)))
    cfg = apply_overrides(cfg, args)
    if args.use_pallas_fusion:
        cfg = cfg.replace(model=cfg.model.replace(use_pallas_fusion=True))
    return cfg


def _gate_variant(state_dict: Dict[str, torch.Tensor], kind: str) -> Dict[str, torch.Tensor]:
    """`state_dict` with the gate's output layer replaced as `kind` says
    ("trained" returns it as it is)."""
    if kind == "trained":
        return state_dict
    if kind not in _GATE_BIAS:
        raise ValueError(kind)
    w, b = state_dict[GATE_OUT + ".weight"], state_dict[GATE_OUT + ".bias"]
    out = dict(state_dict)
    out[GATE_OUT + ".weight"] = torch.zeros_like(w)
    out[GATE_OUT + ".bias"] = torch.tensor(_GATE_BIAS[kind], dtype=b.dtype, device=b.device)
    return out


def _eval(predictor, loader, num_classes: int) -> Dict[str, object]:
    metrics = SegmentationMetrics(num_classes)
    for batch in loader:
        metrics.update(predictor(batch["image"], batch["points"], batch.get("point_valid")),
                       batch["segmentation"])
    return metrics.compute()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def gate_weights(predictor, loader, cfg: ExperimentConfig, max_batches: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(camera weight [N, H, W] float64, BEV occupancy [N, H, W] bool) over
    the first max_batches batches: the gate recomputed in float64 from the
    captured projections and the predictor's gate weights (exact for the
    captured batches), and which cells hold at least one valid LiDAR
    return."""
    fusion = predictor.model.fusion
    captured = {}
    hooks = [getattr(fusion, name).register_forward_hook(
        lambda mod, inp, out, name=name: captured.__setitem__(name, out))
        for name in ("cam_proj", "lidar_proj")]
    a1, a2 = fusion.attention[0], fusion.attention[2]
    w1, b1 = _host(a1.weight[:, :, 0, 0]).T, _host(a1.bias)
    w2, b2 = _host(a2.weight[:, :, 0, 0]).T, _host(a2.bias)
    H, W = cfg.model.lidar.grid_size
    w_cam_all, occ_all = [], []
    try:
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            predictor(batch["image"], batch["points"], batch.get("point_valid"))
            cam = _host(captured["cam_proj"].permute(0, 2, 3, 1))
            lid = _host(captured["lidar_proj"].permute(0, 2, 3, 1))
            h = np.maximum(np.concatenate([cam, lid], axis=-1) @ w1 + b1, 0.0)
            logits = h @ w2 + b2
            e = np.exp(logits - logits.max(-1, keepdims=True))
            w_cam_all.append((e / e.sum(-1, keepdims=True))[..., 0])

            key = bev_cell_key(batch["points"], cfg.model.lidar.grid_size,
                               cfg.model.lidar.point_cloud_range, batch.get("point_valid"))
            occ = np.zeros((key.shape[0], H * W), bool)
            for b in range(key.shape[0]):
                k = key[b]
                occ[b][k[k < H * W]] = True
            occ_all.append(occ.reshape(-1, H, W))
    finally:
        for h in hooks:
            h.remove()
    return np.concatenate(w_cam_all), np.concatenate(occ_all)


def gate_statistics(predictor, loader, cfg: ExperimentConfig, max_batches: int) -> dict:
    """The JAX script's statistics of the camera weight (gate_weights)."""
    w_cam, occ = gate_weights(predictor, loader, cfg, max_batches)
    decisive = float(np.mean(np.maximum(w_cam, 1 - w_cam) > 0.7))
    corr = float(np.corrcoef(w_cam.ravel(), occ.ravel().astype(float))[0, 1])
    return {
        "n_pixels": int(w_cam.size),
        "camera_weight": {
            "mean": round(float(w_cam.mean()), 4),
            "std": round(float(w_cam.std()), 4),
            "p5": round(float(np.percentile(w_cam, 5)), 4),
            "p50": round(float(np.percentile(w_cam, 50)), 4),
            "p95": round(float(np.percentile(w_cam, 95)), 4),
        },
        "decisive_pixel_fraction_gt_0.7": round(decisive, 4),
        "per_sample_spatial_std_mean": round(
            float(w_cam.reshape(w_cam.shape[0], -1).std(axis=1).mean()), 4),
        "corr_camera_weight_vs_bev_occupancy": round(corr, 4),
    }


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    p.add_argument("--checkpoint", default=None,
                   help="default <output-root>/checkpoints/quant_accuracy/best.pth")
    p.add_argument("--stat-batches", type=int, default=4)
    p.add_argument("--output", default=None,
                   help="default <output-root>/docs/weighted_gate_analysis.json")
    p.add_argument("--use-pallas-fusion", action="store_true",
                   help="run the gate through its kernel")
    return p


def main(argv=None) -> dict:
    from lmsu_tpu_torch.evaluate import load_weights
    from lmsu_tpu_torch.inference import Predictor, pin_f32_precision, resolve_device
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()
    checkpoint = args.checkpoint or os.path.join(args.output_root, "checkpoints",
                                                 "quant_accuracy", "best.pth")
    output = args.output or os.path.join(args.output_root, "docs",
                                         "weighted_gate_analysis.json")
    cfg = _regime(args)
    weights = load_weights(checkpoint, cfg.model)
    _, val_loader = build_loaders(cfg, verbose=False)

    pred = Predictor(cfg.model, weights, device=args.device)
    variants = {}
    for kind in GATE_KINDS:
        pred.model.load_state_dict(_gate_variant(weights, kind), strict=True)
        m = _eval(pred, val_loader, cfg.model.num_classes)
        variants[kind] = {"miou": round(m["miou"], 6),
                          "class_iou": [round(v, 6) for v in m["class_iou"]]}
        print(f"{kind:>12s}: mIoU {m['miou']:.4f}  "
              f"class IoU {['%.4f' % v for v in m['class_iou']]}", flush=True)

    print("=== gate statistics (trained weights) ===", flush=True)
    pred.model.load_state_dict(weights, strict=True)
    stats = gate_statistics(pred, val_loader, cfg, args.stat_batches)
    for k, v in stats.items():
        print(f"  {k}: {v}")

    result = {"benchmark": "synthetic_hard",
              "checkpoint": checkpoint,
              "model": "weighted/128 (spatial)",
              "gate_variants_val_miou": variants,
              "gate_stats": stats,
              "gate_contribution_pt": round(
                  100 * (variants["trained"]["miou"] - variants["uniform"]["miou"]), 2)}
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    with open(output, "w") as f:
        json.dump(result, f, indent=2)
    print(f"Wrote {output}")
    return result


if __name__ == "__main__":
    main()
