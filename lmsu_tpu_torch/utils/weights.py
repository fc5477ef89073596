"""JAX-package variables -> the port's state dict.

The inverse of lmsu_tpu/utils/torch_compat.py::convert_torch_state_dict
(:114-180): the port's module tree carries the reference's torch names, so
the JAX package's converter maps the port's state dict back to flax
variables, and a trained JAX checkpoint serves from the port.

`variables` is {"params", "batch_stats"} as nested dicts of numpy arrays
(what `jax.device_get` or the JAX package's `load_checkpoint_raw` return).
Layouts (flax -> torch):
  Conv  [kh, kw, I, O]          -> [O, I, kh, kw]
  Depthwise [k, k, 1, C]        -> [C, 1, k, k]
  Dense [I, O]                  -> Conv1d [O, I, 1]
  attn1_kernel [1, 1, 2C, C]    -> attention.0.weight [C, 2C, 1, 1]
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
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(a))

    def conv(self, tkey: str, path: Tuple[str, ...], bias: bool = False) -> None:
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

    for i, idx in enumerate((0, 3, 6)):
        b.dense(f"lidar_encoder.encoder.point_mlp.{idx}", ("lidar_encoder", "encoder", f"mlp{i}"))
        b.bn(f"lidar_encoder.encoder.point_mlp.{idx + 1}", ("lidar_encoder", "encoder", f"bn{i}"))

    if config.fusion_type != "weighted":
        raise NotImplementedError(f"fusion_type {config.fusion_type!r} is not ported yet")
    for name in ("cam_proj", "lidar_proj"):
        b.conv_bn(f"fusion.{name}.conv.0", f"fusion.{name}.conv.1", ("fusion", name, "block"))
    for i, n in ((0, 1), (2, 2)):
        b._put(f"fusion.attention.{i}.weight",
               b._get(b.params, ("fusion", f"attn{n}_kernel")).transpose(3, 2, 0, 1))
        b._put(f"fusion.attention.{i}.bias", b._get(b.params, ("fusion", f"attn{n}_bias")))

    if config.output_mode != "same":
        raise NotImplementedError(f"output_mode {config.output_mode!r} is not ported yet")
    for i in (0, 1):
        for j, sub in ((0, "dw"), (3, "pw")):
            b.conv_bn(f"head.block.{i}.net.{j}", f"head.block.{i}.net.{j + 1}",
                      ("head", f"block{i + 1}", sub))
    b.conv("head.cls", ("head", "cls"), bias=True)
    return b.sd
