"""Checkpoint evaluation on a CUDA card: split loss, mIoU, per-class IoU.

Counterpart of scripts/evaluate.py for the PyTorch port. Loads a
checkpoint of the port's trainers (latest.pth / best.pth; a plain or a KD
student's; the EMA weights where the run kept them, as the run validated
with them) or a bare state dict, and runs the trainer's own eval epoch over
the val or train split, so the numbers are those training recorded for the
same weights and split.

Usage:
  python -m lmsu_tpu_torch.evaluate --checkpoint checkpoints/run/best.pth \\
      [--device cuda] [--split val] [--fusion-type concat] [--output-json m.json]

The other flags are lmsu_tpu_torch/common.py's; the data is synthetic
unless --dataset (pandaset, packed) and --data-root say otherwise; the
model is concat (256 channels; 128 for the other fusions) unless
--fusion-type and --fusion-channels say otherwise, with --num-classes 3 for
train_pandaset's checkpoints. It raises without a GPU unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import json

from lmsu_tpu_torch.common import add_common_args, apply_overrides, build_loaders
from lmsu_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig


def checkpoint_weights(payload: dict) -> dict:
    """The model state a checkpoint validated with: its model_state (or the
    bare state dict), with the EMA's parameters in place where it has them."""
    state = dict(payload.get("model_state", payload))
    for k, v in (payload.get("ema") or {}).items():
        if k.startswith("model."):
            state[k[len("model."):]] = v
    return state


def load_weights(path: str, model_config: ModelConfig) -> dict:
    """The model state dict of a checkpoint, told by content: a torch file
    of the port's trainers (checkpoint_weights: the EMA's parameters where
    the run kept them) or a JAX-package flax checkpoint (its EMA shadow
    where present, converted by utils/weights.py)."""
    from lmsu_tpu_torch.training.checkpoint import load_checkpoint
    from lmsu_tpu_torch.utils.flax_checkpoint import is_torch_file, load_model_variables
    from lmsu_tpu_torch.utils.weights import from_jax_variables
    if is_torch_file(path):
        return checkpoint_weights(load_checkpoint(path))
    return from_jax_variables(load_model_variables(path), model_config)


def evaluate_checkpoint(cfg: ExperimentConfig, checkpoint: str, split: str = "val",
                        device="cuda") -> dict:
    """Load `checkpoint` into the trainer's model and run one eval epoch
    (with the loaded weights: the EMA's, if any, come from the checkpoint).
    Returns {"checkpoint", "split", "loss", "miou", "class_iou"}."""
    import dataclasses

    from lmsu_tpu_torch.training import Trainer
    from lmsu_tpu_torch.training.checkpoint import load_checkpoint
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=None))
    train_loader, val_loader = build_loaders(cfg, verbose=False)
    trainer = Trainer(cfg, train_loader, val_loader, device=device)
    trainer.model.load_state_dict(checkpoint_weights(load_checkpoint(checkpoint)), strict=True)
    loss, metrics = trainer._run_epoch(val_loader if split == "val" else train_loader,
                                       train=False)
    return {"checkpoint": checkpoint, "split": split, "loss": float(loss),
            "miou": float(metrics["miou"]),
            "class_iou": [float(v) for v in metrics["class_iou"]]}


def build_config(args) -> ExperimentConfig:
    fusion = args.fusion_type or "concat"
    cfg = ExperimentConfig(
        model=ModelConfig(num_classes=args.num_classes, fusion_type=fusion,
                          fusion_out_channels=256 if fusion == "concat" else 128),
        data=DataConfig(dataset="synthetic"), train=TrainConfig(class_weights=(0.4, 3.5)))
    return apply_overrides(cfg, args)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="a checkpoint of the port's trainers (plain or KD) or a state dict")
    p.add_argument("--split", default="val", choices=["val", "train"])
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--output-json", default=None,
                   help="also write the metrics dict to this path")
    return p


def main(argv=None) -> dict:
    from lmsu_tpu_torch.inference import pin_f32_precision, resolve_device
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    pin_f32_precision()
    result = evaluate_checkpoint(build_config(args), args.checkpoint, args.split, args.device)
    print(f"{args.split} loss {result['loss']:.4f}  mIoU {result['miou']:.4f}  "
          f"class IoU {['%.4f' % v for v in result['class_iou']]}")
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(result, f, indent=2)
        print(f"Wrote {args.output_json}")
    return result


if __name__ == "__main__":
    main()
