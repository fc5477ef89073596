"""Int8 (w8a8) post-training quantisation accuracy on a TRAINED model.

Counterpart of scripts/experiment_quant_accuracy.py: the val mIoU of the
int8 path against the float path on a trained checkpoint, on the hard
synthetic benchmark, which is what a deployment contract cares about.

Protocol:
  1. train (or --checkpoint to reuse) a weighted/128 student on the hard
     benchmark in kd_lift's regime (400 / 512, 40 epochs);
  2. calibrate the activations' absmax on --calib-batches TRAIN batches
     (calibration never sees the val split; Predictor.quantize, through
     inference.py::calibrate_quant);
  3. evaluate val mIoU both ways with the same Predictor weights (the float
     path, then the int8 path), with per-class IoU (ops/metrics.py::
     iou_from_confusion), the mIoU delta and the pixel argmax agreement.

Usage:
  python -m lmsu_tpu_torch.experiments.quant_accuracy [--device cuda] \\
      [--checkpoint FILE] [--calib-batches 4] [--output-root torch_runs] [--output FILE] \\
      [--scatter-impl sorted_pallas] [--use-pallas-fusion] [--fused-inference]

--checkpoint takes a torch checkpoint of the port's trainers or a flax
checkpoint of the JAX package (evaluate.py::load_weights). Writes
<output-root>/docs/quant_accuracy.json (the script's schema plus `device`,
the card's name and power limit, or "cpu"); the run directory is
<output-root>/checkpoints/quant_accuracy/. The serving opt-ins
(--scatter-impl sorted_pallas --use-pallas-fusion --fused-inference) run
the model through K1, K2 and K3, off by default as in the script.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from lmsu_tpu_torch.common import (add_common_args, add_output_root_arg, apply_overrides,
                                   build_loaders, device_label)
from lmsu_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from lmsu_tpu_torch.experiments import run_dir, setup_device, write_json
from lmsu_tpu_torch.ops.metrics import iou_from_confusion


def _regime(args) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=128),
        data=DataConfig(dataset="synthetic", synthetic_difficulty="hard",
                        synthetic_num_train=400, synthetic_num_val=512, batch_size=32),
        train=TrainConfig(num_epochs=40, class_weights=(0.4, 3.5), onchip_epoch=True,
                          save_dir=run_dir(args, "quant_accuracy")))
    cfg = apply_overrides(cfg, args)
    model = cfg.model
    if args.use_pallas_fusion:
        model = model.replace(use_pallas_fusion=True)
    if args.fused_inference:
        model = model.replace(camera=dataclasses.replace(model.camera, fused_inference=True))
    return cfg.replace(model=model)


def _eval_predictor(predictor, loader, num_classes: int):
    """Val confusion (summed on the device) and the per-batch argmax masks
    (host) for the agreement metric."""
    from lmsu_tpu_torch.ops.metrics import confusion_matrix
    cm = torch.zeros((num_classes, num_classes), dtype=torch.long, device=predictor.device)
    masks = []
    for batch in loader:
        logits = predictor(batch["image"], batch["points"], batch.get("point_valid"))
        target = torch.as_tensor(np.asarray(batch["segmentation"]), device=predictor.device)
        cm += confusion_matrix(logits, target, num_classes)
        masks.append(logits.argmax(dim=-1).to(torch.int32).cpu().numpy())
    return cm.cpu().numpy(), np.concatenate(masks)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_output_root_arg(p)
    p.add_argument("--checkpoint", default=None,
                   help="reuse a trained checkpoint instead of training")
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--output", default=None,
                   help="default <output-root>/docs/quant_accuracy.json")
    p.add_argument("--use-pallas-fusion", action="store_true",
                   help="run the weighted-fusion gate through its kernel")
    p.add_argument("--fused-inference", action="store_true",
                   help="run the camera encoder's InvertedResidual blocks through the "
                   "fused inference kernel")
    return p


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    setup_device(args)
    from lmsu_tpu_torch.evaluate import load_weights
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.training import Trainer

    cfg = _regime(args)
    output = args.output or os.path.join(args.output_root, "docs", "quant_accuracy.json")
    train_loader, val_loader = build_loaders(cfg)
    if args.checkpoint:
        state = load_weights(args.checkpoint, cfg.model)
        trained_miou = None
    else:
        print("=== training the fp32 baseline (hard benchmark) ===", flush=True)
        trainer = Trainer(cfg, train_loader, val_loader, device=args.device)
        trained_miou = float(trainer.train())
        trainer.flush_checkpoints()
        del trainer
        # Evaluate the BEST-epoch weights (what a deployment would ship).
        state = load_weights(os.path.join(cfg.train.save_dir, "best.pth"), cfg.model)

    # -- float path ------------------------------------------------------------
    pred = Predictor(cfg.model, state, device=args.device)
    print("=== evaluating fp32 path ===", flush=True)
    cm_fp, mask_fp = _eval_predictor(pred, val_loader, cfg.model.num_classes)
    fp = iou_from_confusion(cm_fp)

    # -- int8 path (calibrated on train batches only) ----------------------------
    calib = []
    for i, batch in enumerate(train_loader):
        if i >= args.calib_batches:
            break
        calib.append(batch)
    print(f"=== calibrating int8 on {len(calib)} train batches ===", flush=True)
    pred.quantize(calib)
    print("=== evaluating int8 path ===", flush=True)
    cm_q, mask_q = _eval_predictor(pred, val_loader, cfg.model.num_classes)
    q = iou_from_confusion(cm_q)

    agreement = float((mask_fp == mask_q).mean())
    result = {
        "benchmark": "synthetic_hard",
        "model": f"{cfg.model.fusion_type}/{cfg.model.fusion_out_channels}"
                 f" ({cfg.model.lidar.encoder_type})",
        "regime": "kd_lift (400/512, 40ep)" if not args.checkpoint
                  else f"checkpoint {args.checkpoint}",
        "seed": cfg.train.seed,
        "calib_batches": len(calib),
        "trained_best_miou": trained_miou,
        "fp32": {"miou": round(fp["miou"], 6),
                 "class_iou": [round(v, 6) for v in fp["class_iou"]]},
        "int8": {"miou": round(q["miou"], 6),
                 "class_iou": [round(v, 6) for v in q["class_iou"]]},
        "miou_delta": round(q["miou"] - fp["miou"], 6),
        "argmax_agreement": round(agreement, 6),
        "device": device_label(pred.device),
    }
    write_json(output, result)
    print(f"\nfp32 mIoU {fp['miou']:.4f} | int8 mIoU {q['miou']:.4f} "
          f"(delta {result['miou_delta']:+.4f}) | argmax agreement {agreement:.4%}")
    print(f"Wrote {output}")
    return result


if __name__ == "__main__":
    main()
