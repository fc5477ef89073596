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

`kernel_table` is the one table of the port's weights: each module that
holds one -> its flax kernel's path, the flax initialiser that draws it,
its bias and its BatchNorm. `from_jax_variables` converts by it, and
models/factory.py::create_model draws each weight by its initialiser
(`init_kernel`): flax's laws, the RNG the port's own.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lmsu_tpu_torch.config import ModelConfig

_STAGES = (("stage1", 1), ("stage2", 6), ("stage3", 6), ("stage4", 6), ("stage5", 6))

#: The flax initialisers the port's weights mirror, as (scale, mode) of
#: flax's variance_scaling with a truncated normal: conv_init
#: (lmsu_tpu/models/layers.py:31; every Conv, the transposed convs of the x4
#: head and the gate's 1x1 kernels) and lecun_normal, flax's default for
#: nn.Dense (the point MLP and the pillar net).
INITIALISERS = {"conv_init": (2.0, "fan_out"), "lecun_normal": (1.0, "fan_in")}
#: The std of a unit normal cut at +-2 (flax's truncated_normal divides by it).
TRUNC_STD = 0.87962566103423978


class Kernel(NamedTuple):
    """A port weight's flax counterpart: the kernel's path in `params`, its
    initialiser (a key of INITIALISERS), the bias's path (None without
    one; biases start at zero) and (the port's BatchNorm name, its flax path)
    of the BatchNorm after it (None without one; BatchNorm starts at
    identity)."""
    path: Tuple[str, ...]
    init: str
    bias: Optional[Tuple[str, ...]] = None
    bn: Optional[Tuple[str, Tuple[str, ...]]] = None


def flax_kernel_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The flax kernel's shape of a port weight of `shape` (the layouts
    above): [O, I, kh, kw] (and a transposed conv's [I, O, kh, kw]) ->
    [kh, kw, I, O] ([kh, kw, O, I]); Conv1d [O, I, 1] -> Dense [I, O]."""
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 3 and shape[2] == 1:
        return (shape[1], shape[0])
    raise ValueError(f"no flax kernel layout for a weight of shape {tuple(shape)}")


def init_std(init: str, shape: Tuple[int, ...]) -> float:
    """The std of the weights flax's `init` draws for a port weight of
    `shape`: sqrt(scale / fan), the fans as flax computes them on the flax
    kernel's shape (in axis -2, out axis -1, the rest receptive field). The
    normal before the cut at +-2 has this std / TRUNC_STD."""
    scale, mode = INITIALISERS[init]
    fshape = flax_kernel_shape(shape)
    receptive = math.prod(fshape[:-2])
    fan = fshape[-2 if mode == "fan_in" else -1] * receptive
    return math.sqrt(scale / fan)


def init_kernel(weight: torch.Tensor, init: str, generator: torch.Generator) -> None:
    """Draws `weight` in place by flax's `init` from `generator`: a normal of
    std init_std / TRUNC_STD cut at two of its stds."""
    sigma = init_std(init, tuple(weight.shape)) / TRUNC_STD
    torch.nn.init.trunc_normal_(weight, std=sigma, a=-2 * sigma, b=2 * sigma,
                                generator=generator)


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

    def kernel(self, tkey: str, path: Tuple[str, ...]) -> None:
        a = self._get(self.params, path)
        # [kh, kw, I, O] -> [O, I, kh, kw]; for a transposed conv the same
        # transpose takes [kh, kw, O, I] to torch's [I, O, kh, kw]. A Dense
        # [I, O] -> Conv1d [O, I, 1].
        self._put(f"{tkey}.weight", a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T[:, :, None])

    def bn(self, tkey: str, path: Tuple[str, ...]) -> None:
        self._put(f"{tkey}.weight", self._get(self.params, path + ("scale",)))
        self._put(f"{tkey}.bias", self._get(self.params, path + ("bias",)))
        self._put(f"{tkey}.running_mean", self._get(self.stats, path + ("mean",)))
        self._put(f"{tkey}.running_var", self._get(self.stats, path + ("var",)))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


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


def kernel_table(config: ModelConfig) -> Dict[str, Kernel]:
    """Every module of the port's model that holds a weight (a conv, a
    transposed conv, a Conv1d standing for a Dense) -> its flax
    counterpart (Kernel), in the order from_jax_variables writes them."""
    out: Dict[str, Kernel] = OrderedDict()
    for path, (tconv, tbn) in convbn_names(config).items():
        out[tconv] = Kernel(path + ("conv", "kernel"), "conv_init", bn=(tbn, path + ("bn",)))

    # The spatial encoder's point_mlp (JAX mlp{i}), or the pillar net's
    # pfn (JAX pfn{i}): flax Dense layers; bn{i} in both.
    seq, dense = (("pfn", "pfn") if config.lidar.encoder_type == "pointpillars"
                  else ("point_mlp", "mlp"))
    enc = ("lidar_encoder", "encoder")
    for i in range(len(config.lidar.mlp_dims) + 1):
        out[f"lidar_encoder.encoder.{seq}.{3 * i}"] = Kernel(
            enc + (f"{dense}{i}", "kernel"), "lecun_normal", bias=enc + (f"{dense}{i}", "bias"),
            bn=(f"lidar_encoder.encoder.{seq}.{3 * i + 1}", enc + (f"bn{i}",)))

    if config.fusion_type in ("weighted", "gated_sum"):  # the gate net, weighted's names
        for i, n in ((0, 1), (2, 2)):
            out[f"fusion.attention.{i}"] = Kernel(("fusion", f"attn{n}_kernel"), "conv_init",
                                                  bias=("fusion", f"attn{n}_bias"))

    if config.output_mode == "x4":
        for i in (1, 2):
            out[f"head.up{i}.0"] = Kernel(("head", f"up{i}_deconv", "kernel"), "conv_init",
                                          bn=(f"head.up{i}.1", ("head", f"up{i}_bn")))
    out["head.cls"] = Kernel(("head", "cls", "kernel"), "conv_init", bias=("head", "cls", "bias"))
    return out


def from_jax_variables(variables: Mapping[str, Any], config: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """JAX-package model variables -> a state dict for the port's model."""
    b = _Converter(variables)
    for tname, k in kernel_table(config).items():
        b.kernel(tname, k.path)
        if k.bias is not None:
            b._put(f"{tname}.bias", b._get(b.params, k.bias))
        if k.bn is not None:
            b.bn(*k.bn)
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
