"""JAX-package variables -> the port's state dict.

The inverse of lmsu_tpu/utils/torch_compat.py::convert_torch_state_dict
(:114-180): the port's module tree carries the reference's torch names, so
the JAX package's converter maps the port's state dict back to flax
variables, and a trained JAX checkpoint serves from the port.

`variables` is {"params", "batch_stats"} as nested dicts of numpy arrays
(what `jax.device_get` or the JAX package's `load_checkpoint_raw` return).
The KD projections ([Ct, Cs] per tap, under the JAX state's
`params["proj"]`) carry across in the same layout both ways.

`from_jax_quant_stats` carries the JAX package's int8 calibration (its
"quant_stats" collection) across by the same names (`convbn_names`).

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


def convbn_names(config: ModelConfig) -> Dict[Tuple[str, ...], Tuple[str, str]]:
    """Each of the JAX package's ConvBNAct modules, by its path in the flax
    variables (("camera_fpn", "post", "pw"), ...), -> the port's names of
    its conv and its BatchNorm."""
    out: Dict[Tuple[str, ...], Tuple[str, str]] = OrderedDict()

    def pair(tconv: str, tbn: str, path: Tuple[str, ...]) -> None:
        out[path] = (tconv, tbn)
    pair("camera_encoder.stem.0", "camera_encoder.stem.1", ("camera_encoder", "stem"))
    for stage, exp in _STAGES:
        t, path = f"camera_encoder.{stage}.conv", ("camera_encoder", stage)
        names = (("expand", 0), ("depthwise", 3), ("project", 6)) if exp != 1 \
            else (("depthwise", 0), ("project", 3))
        for sub, i in names:
            pair(f"{t}.{i}", f"{t}.{i + 1}", path + (sub,))

    if config.camera.return_multiscale:
        for s in config.camera_fpn_stages or ("stage2", "stage3", "stage4", "stage5"):
            pair(f"camera_fpn.laterals.{s}.conv.0", f"camera_fpn.laterals.{s}.conv.1",
                 ("camera_fpn", f"lateral_{s}", "block"))
        pair("camera_fpn.post.net.0", "camera_fpn.post.net.1", ("camera_fpn", "post", "dw"))
        pair("camera_fpn.post.net.3", "camera_fpn.post.net.4", ("camera_fpn", "post", "pw"))

    if config.fusion_type == "concat":
        projections = ("camera_proj", "lidar_proj")
    elif config.fusion_type in ("minimal", "weighted", "gated_sum"):
        projections = ("cam_proj", "lidar_proj")
    else:
        raise ValueError(f"Unknown fusion_type: {config.fusion_type}")
    for name in projections:
        pair(f"fusion.{name}.conv.0", f"fusion.{name}.conv.1", ("fusion", name, "block"))
    if config.fusion_type == "concat":
        pair("fusion.fuse.0", "fusion.fuse.1", ("fusion", "fuse_dw"))
        pair("fusion.fuse.3", "fusion.fuse.4", ("fusion", "fuse_pw"))

    if config.output_mode == "same":
        for i in (0, 1):
            for j, sub in ((0, "dw"), (3, "pw")):
                pair(f"head.block.{i}.net.{j}", f"head.block.{i}.net.{j + 1}",
                     ("head", f"block{i + 1}", sub))
    elif config.output_mode != "x4":
        raise ValueError(f"Unknown output_mode: {config.output_mode}")
    return out


def from_jax_variables(variables: Mapping[str, Any], config: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """JAX-package model variables -> a state dict for the port's model."""
    b = _Converter(variables)
    for path, (tconv, tbn) in convbn_names(config).items():
        b.conv_bn(tconv, tbn, path)

    # The spatial encoder's point_mlp (JAX mlp{i}), or the pillar net's
    # pfn (JAX pfn{i}), in the same layout; bn{i} in both.
    seq, dense = (("pfn", "pfn") if config.lidar.encoder_type == "pointpillars"
                  else ("point_mlp", "mlp"))
    for i in range(len(config.lidar.mlp_dims) + 1):
        b.dense(f"lidar_encoder.encoder.{seq}.{3 * i}", ("lidar_encoder", "encoder", f"{dense}{i}"))
        b.bn(f"lidar_encoder.encoder.{seq}.{3 * i + 1}", ("lidar_encoder", "encoder", f"bn{i}"))

    if config.fusion_type in ("weighted", "gated_sum"):  # the gate net, weighted's names
        for i, n in ((0, 1), (2, 2)):
            b._put(f"fusion.attention.{i}.weight",
                   b._get(b.params, ("fusion", f"attn{n}_kernel")).transpose(3, 2, 0, 1))
            b._put(f"fusion.attention.{i}.bias", b._get(b.params, ("fusion", f"attn{n}_bias")))

    if config.output_mode == "x4":
        for i in (1, 2):
            b.conv(f"head.up{i}.0", ("head", f"up{i}_deconv"))
            b.bn(f"head.up{i}.1", ("head", f"up{i}_bn"))
    b.conv("head.cls", ("head", "cls"), bias=True)
    return b.sd


def from_jax_quant_stats(quant_stats: Mapping[str, Any], config: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's "quant_stats" collection (nested dicts, one
    {"act_absmax": scalar} per calibrated ConvBNAct, inference.py::
    calibrate_quant) -> the port's calibrated absmax by conv name, as
    models/layers.py::set_quant_stats takes it. A path that names no
    ConvBNAct of `config` raises KeyError."""
    names = convbn_names(config)
    out: Dict[str, torch.Tensor] = OrderedDict()

    def walk(tree, path):
        if "act_absmax" in tree:
            if path not in names:
                raise KeyError(f"quant_stats path {'/'.join(path)} is no ConvBNAct of this model")
            out[names[path][0]] = torch.tensor(float(np.asarray(tree["act_absmax"])),
                                               dtype=torch.float32)
        for k, v in tree.items():
            if k != "act_absmax":
                walk(v, path + (k,))
    walk(quant_stats, ())
    return out


def from_jax_projections(projections: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The KD projections of a JAX-package state (`params["proj"]`, one
    [Ct, Cs] array per tap) -> tensors in the same layout (no transpose)."""
    return {tap: torch.from_numpy(np.array(p, np.float32)) for tap, p in projections.items()}


def to_jax_projections(projections: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's KD projections -> numpy [Ct, Cs] arrays for the JAX package."""
    return {tap: p.detach().cpu().float().numpy() for tap, p in projections.items()}
