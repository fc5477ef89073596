"""Single-frame / batch inference: the Predictor of the PyTorch port.

Counterpart of lmsu_tpu/inference.py::Predictor (__init__, _maybe_sort,
__call__, predict_mask, from_torch_checkpoint). Weights come from a port
state dict, a reference `.pth` (same module names), or a seeded random
init. Not ported yet: freeze_weights, quantize, export and from_checkpoint
(flax msgpack; convert with utils/weights.py::from_jax_variables instead).

    predictor = Predictor(cfg, state_dict, device="cuda")
    mask = predictor.predict_mask(image_u8, points)          # [H, W] int32
    logits = predictor(images, points)                       # batched, on device
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.data.rasterize import make_point_sorter
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.factory import check_kernel_shapes


def pin_f32_precision() -> None:
    """Full f32 for f32 work on the card: cuDNN convolutions and cuBLAS
    matmuls without TF32 (PyTorch's default lets cuDNN use TF32, which keeps
    about three decimal digits). The port's f32 is held against the JAX
    package at "highest" precision, so the CLIs and chip_smoke.py set this
    once at start-up; the JAX package has no flag for it either."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default, and asking
    for it without a GPU raises: the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class Predictor:
    def __init__(self, config: ModelConfig,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, *,
                 device="cuda", seed: int = 0):
        """Build the model on `device` in eval mode, with `state_dict` loaded
        strictly, or weights drawn from `seed` when it is None."""
        self.device = resolve_device(device)
        self.config = config
        self.model = create_model(config, seed=seed)
        check_kernel_shapes(self.model, self.device, train=False)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        # The sorted-input scatter's contract is a pipeline property that
        # serving callers should not have to know: sort incoming points on
        # the host when the config selects that scatter.
        self._sorter = None
        if config.lidar.scatter_impl == "sorted_pallas":
            self._sorter = make_point_sorter(config.lidar.grid_size,
                                             config.lidar.point_cloud_range)

    @classmethod
    def from_torch_checkpoint(cls, path: str, config: ModelConfig, *,
                              device="cuda") -> "Predictor":
        """Load a reference PyTorch .pth (trainer checkpoint with
        'model_state', or a bare state dict) or a saved port state dict."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return cls(config, ckpt.get("model_state", ckpt), device=device)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype=dtype)

    def forward_batch(self, images, points, point_valid=None) -> torch.Tensor:
        """Logits [B, h, w, num_classes] on the device, in the compute dtype,
        for inputs already in the scatter's order (no host sort). Runs under
        inference_mode itself: the serving engine calls it from its own
        thread, where a caller's grad mode does not reach."""
        with torch.inference_mode():
            images = self._tensor(images)
            if images.dtype != torch.uint8:
                images = images.float()
            pv = None if point_valid is None else self._tensor(point_valid, torch.bool)
            return self.model(images, self._tensor(points, torch.float32), pv)

    def __call__(self, images, points, point_valid=None) -> torch.Tensor:
        """Batched logits [B, h, w, num_classes] (on the device).

        Pass the pipeline's `point_valid` mask when the points were
        zero-padded so serving matches training: without it, pad points
        count as real returns at the BEV grid centre."""
        points, point_valid = self._maybe_sort(points, point_valid)
        return self.forward_batch(images, points, point_valid)

    def _maybe_sort(self, points, point_valid):
        if self._sorter is None:
            return points, point_valid
        pts = np.asarray(points)
        pv = None if point_valid is None else np.asarray(point_valid)
        batched = pts.ndim == 3
        rows = pts if batched else pts[None]
        pvs = pv if pv is None or batched else pv[None]
        out_p, out_v = [], []
        for i in range(rows.shape[0]):
            s = {"points": rows[i]}
            if pvs is not None:
                s["point_valid"] = pvs[i]
            s = self._sorter(s)
            out_p.append(s["points"])
            out_v.append(s.get("point_valid"))
        pts = np.stack(out_p)
        if not batched:
            pts = pts[0]
        if pv is None:
            return pts, None
        pv = np.stack(out_v)
        return pts, (pv if batched else pv[0])

    def predict_mask(self, image, points, point_valid=None) -> np.ndarray:
        """Single frame -> [H, W] int32 class mask."""
        points, point_valid = self._maybe_sort(points, point_valid)
        image = np.asarray(image)
        images = image[None] if image.ndim == 3 else image
        pts = np.asarray(points)
        pts = pts[None] if pts.ndim == 2 else pts
        pv = None
        if point_valid is not None:
            pv = np.asarray(point_valid)
            pv = pv[None] if pv.ndim == 1 else pv
        logits = self.forward_batch(images, pts, pv)
        return logits.argmax(dim=-1)[0].to(torch.int32).cpu().numpy()
