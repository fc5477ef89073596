"""JAX-package variables -> the port's state dict.

The inverse of lmsu_tpu/utils/torch_compat.py::convert_torch_state_dict
(:114-180): the port's module tree carries the reference's torch names, so
the JAX package's converter maps the port's state dict back to flax
variables, and a trained JAX checkpoint serves from the port.

`variables` is {"params", "batch_stats"} as nested dicts of numpy arrays
(what `jax.device_get` or the JAX package's `load_checkpoint_raw` return).
The KD projections ([Ct, Cs] per tap, under the JAX state's
`params["proj"]`) carry across in the same layout both ways.

The pillar encoder (encoder_type "pointpillars") maps JAX's
`lidar_encoder/encoder/pfn{i}` and `bn{i}` to the port's
`lidar_encoder.encoder.pfn.{3i}` and `.{3i + 1}`. The reference has no
pillar net, so the JAX converter (convert_torch_state_dict, which knows
only `point_mlp`) does not cover it: pillar weights carry from the JAX
package to the port only.
Layouts (flax -> torch):
  Conv  [kh, kw, I, O]          -> [O, I, kh, kw]
  Depthwise [k, k, 1, C]        -> [C, 1, k, k]
  Dense [I, O]                  -> Conv1d [O, I, 1]
  attn1_kernel [1, 1, 2C, C]    -> attention.0.weight [C, 2C, 1, 1]
  ConvTranspose2dTorch [kh, kw, O, I] -> ConvTranspose2d [I, O, kh, kw]
                                   (a transpose only: no spatial flip)
  BN scale/bias/mean/var        -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from lmsu_tpu_torch.config import ModelConfig

_STAGES = (("stage1", 1), ("stage2", 6), ("stage3", 6), ("stage4", 6), ("stage5", 6))


class _Converter:
    def __init__(self, variables: Mapping[str, Any]):
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.sd: Dict[str, torch.Tensor] = OrderedDict()

    @staticmethod
    def _get(tree, path: Tuple[str, ...]) -> np.ndarray:
        for p in path:
            tree = tree[p]
        return np.asarray(tree, np.float32)

    def _put(self, key: str, a: np.ndarray) -> None:
        self.sd[key] = torch.from_numpy(np.array(a, order="C"))  # a writable copy

    def conv(self, tkey: str, path: Tuple[str, ...], bias: bool = False) -> None:
        # [kh, kw, I, O] -> [O, I, kh, kw]; for a transposed conv the same
        # transpose takes [kh, kw, O, I] to torch's [I, O, kh, kw].
        self._put(f"{tkey}.weight", self._get(self.params, path + ("kernel",))
                  .transpose(3, 2, 0, 1))
        if bias:
            self._put(f"{tkey}.bias", self._get(self.params, path + ("bias",)))

    def dense(self, tkey: str, path: Tuple[str, ...]) -> None:
        self._put(f"{tkey}.weight", self._get(self.params, path + ("kernel",)).T[:, :, None])
        self._put(f"{tkey}.bias", self._get(self.params, path + ("bias",)))

    def bn(self, tkey: str, path: Tuple[str, ...]) -> None:
        self._put(f"{tkey}.weight", self._get(self.params, path + ("scale",)))
        self._put(f"{tkey}.bias", self._get(self.params, path + ("bias",)))
        self._put(f"{tkey}.running_mean", self._get(self.stats, path + ("mean",)))
        self._put(f"{tkey}.running_var", self._get(self.stats, path + ("var",)))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def conv_bn(self, tconv: str, tbn: str, path: Tuple[str, ...]) -> None:
        self.conv(tconv, path + ("conv",))
        self.bn(tbn, path + ("bn",))


def from_jax_variables(variables: Mapping[str, Any], config: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """JAX-package model variables -> a state dict for the port's model."""
    b = _Converter(variables)
    b.conv_bn("camera_encoder.stem.0", "camera_encoder.stem.1", ("camera_encoder", "stem"))
    for stage, exp in _STAGES:
        t, path = f"camera_encoder.{stage}.conv", ("camera_encoder", stage)
        names = (("expand", 0), ("depthwise", 3), ("project", 6)) if exp != 1 \
            else (("depthwise", 0), ("project", 3))
        for sub, i in names:
            b.conv_bn(f"{t}.{i}", f"{t}.{i + 1}", path + (sub,))

    if config.camera.return_multiscale:
        for s in config.camera_fpn_stages or ("stage2", "stage3", "stage4", "stage5"):
            b.conv_bn(f"camera_fpn.laterals.{s}.conv.0", f"camera_fpn.laterals.{s}.conv.1",
                      ("camera_fpn", f"lateral_{s}", "block"))
        b.conv_bn("camera_fpn.post.net.0", "camera_fpn.post.net.1", ("camera_fpn", "post", "dw"))
        b.conv_bn("camera_fpn.post.net.3", "camera_fpn.post.net.4", ("camera_fpn", "post", "pw"))

    # The spatial encoder's point_mlp (JAX mlp{i}), or the pillar net's
    # pfn (JAX pfn{i}), in the same layout; bn{i} in both.
    seq, dense = (("pfn", "pfn") if config.lidar.encoder_type == "pointpillars"
                  else ("point_mlp", "mlp"))
    for i in range(len(config.lidar.mlp_dims) + 1):
        b.dense(f"lidar_encoder.encoder.{seq}.{3 * i}", ("lidar_encoder", "encoder", f"{dense}{i}"))
        b.bn(f"lidar_encoder.encoder.{seq}.{3 * i + 1}", ("lidar_encoder", "encoder", f"bn{i}"))

    if config.fusion_type == "concat":
        for name in ("camera_proj", "lidar_proj"):
            b.conv_bn(f"fusion.{name}.conv.0", f"fusion.{name}.conv.1", ("fusion", name, "block"))
        b.conv_bn("fusion.fuse.0", "fusion.fuse.1", ("fusion", "fuse_dw"))
        b.conv_bn("fusion.fuse.3", "fusion.fuse.4", ("fusion", "fuse_pw"))
    elif config.fusion_type in ("minimal", "weighted", "gated_sum"):
        for name in ("cam_proj", "lidar_proj"):
            b.conv_bn(f"fusion.{name}.conv.0", f"fusion.{name}.conv.1", ("fusion", name, "block"))
        if config.fusion_type != "minimal":  # the gate net, weighted's names for both
            for i, n in ((0, 1), (2, 2)):
                b._put(f"fusion.attention.{i}.weight",
                       b._get(b.params, ("fusion", f"attn{n}_kernel")).transpose(3, 2, 0, 1))
                b._put(f"fusion.attention.{i}.bias", b._get(b.params, ("fusion", f"attn{n}_bias")))
    else:
        raise ValueError(f"Unknown fusion_type: {config.fusion_type}")

    if config.output_mode == "same":
        for i in (0, 1):
            for j, sub in ((0, "dw"), (3, "pw")):
                b.conv_bn(f"head.block.{i}.net.{j}", f"head.block.{i}.net.{j + 1}",
                          ("head", f"block{i + 1}", sub))
    elif config.output_mode == "x4":
        for i in (1, 2):
            b.conv(f"head.up{i}.0", ("head", f"up{i}_deconv"))
            b.bn(f"head.up{i}.1", ("head", f"up{i}_bn"))
    else:
        raise ValueError(f"Unknown output_mode: {config.output_mode}")
    b.conv("head.cls", ("head", "cls"), bias=True)
    return b.sd


def from_jax_projections(projections: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The KD projections of a JAX-package state (`params["proj"]`, one
    [Ct, Cs] array per tap) -> tensors in the same layout (no transpose)."""
    return {tap: torch.from_numpy(np.array(p, np.float32)) for tap, p in projections.items()}


def to_jax_projections(projections: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's KD projections -> numpy [Ct, Cs] arrays for the JAX package."""
    return {tap: p.detach().cpu().float().numpy() for tap, p in projections.items()}
