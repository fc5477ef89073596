"""Single-frame / batch inference: the Predictor of the PyTorch port.

Counterpart of lmsu_tpu/inference.py: Predictor (__init__ with
freeze_weights, quantize, from_checkpoint, from_torch_checkpoint,
_maybe_sort, __call__, predict_mask, export), calibrate_quant and
load_exported. Weights come from a port state dict, a reference `.pth`
(same module names), the JAX package's flax checkpoint, or a seeded random
init.

    predictor = Predictor(cfg, state_dict, device="cuda")
    predictor = Predictor.from_checkpoint("run/best.ckpt", cfg)   # flax msgpack
    mask = predictor.predict_mask(image_u8, points)          # [H, W] int32
    logits = predictor(images, points)                       # batched, on device
    predictor.quantize(calibration_batches)                  # w8a8 1x1 convs
    predictor.export("student.pt2", batch_size=8)            # torch.export artifact
    serve = load_exported("student.pt2")                     # no model code needed
"""

from __future__ import annotations

import copy
import json
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.data.rasterize import make_point_sorter
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.factory import check_kernel_shapes
from lmsu_tpu_torch.models.frozen import freeze_model
from lmsu_tpu_torch.models.layers import calibration, quant_stats, set_quant_stats

# The artifact's own record (torch.export.save's extra_files): its inputs,
# its scatter route and grid (the point-sort contract), its device.
ARTIFACT_META = "lmsu_tpu_torch.json"


def pin_f32_precision() -> None:
    """Full f32 for f32 work on the card: cuDNN convolutions and cuBLAS
    matmuls without TF32 (PyTorch's default lets cuDNN use TF32, which keeps
    about three decimal digits). The port's f32 is held against the JAX
    package at "highest" precision, so the CLIs and chip_smoke.py set this
    once at start-up; the JAX package has no flag for it either."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def to_device(a, device, dtype=None) -> torch.Tensor:
    """An array or tensor as a tensor on `device` (in `dtype` when given)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, dtype=dtype)


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
                 device="cuda", seed: int = 0, freeze_weights: bool = False):
        """Build the model on `device` in eval mode, with `state_dict` loaded
        strictly, or weights drawn from `seed` when it is None.

        freeze_weights=True serves a frozen copy (models/frozen.py): every
        eval BatchNorm folded into its conv once, and each fused block's
        folded parameters computed once, as the JAX package's frozen
        Predictor lets XLA fold them into constants. The engine then
        refuses a weight swap (ServingEngine.swap_variables)."""
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
        self._freeze_weights = freeze_weights
        self._build_forwards()

    def _build_forwards(self) -> None:
        """The module forwards run: the model, or its frozen copy."""
        self._served = freeze_model(self.model) if self._freeze_weights else self.model

    def replica(self, device) -> "Predictor":
        """A copy of this Predictor on `device` (data-parallel serving): the
        model, its int8 calibration and the frozen copy, if any, rebuilt
        there; the config and the sorter shared."""
        rep = copy.copy(self)
        rep.device = resolve_device(device)
        with torch.no_grad():
            rep.model = copy.deepcopy(self.model).to(rep.device)
            for m in rep.model.modules():
                if isinstance(getattr(m, "act_absmax", None), torch.Tensor):
                    m.act_absmax = m.act_absmax.to(rep.device)
        rep._build_forwards()
        return rep

    def quantize(self, calibration_batches) -> None:
        """Switch this Predictor to int8 (w8a8) serving.

        Runs an eval calibration pass over `calibration_batches` (dicts with
        "image"/"points"[/"point_valid"], or (image, points[, point_valid])
        tuples) recording each eligible 1x1 conv's input absmax
        (calibrate_quant), then serves those convs on the s8 x s8 -> s32
        path (ops/quant.py; models/layers.py). A frozen Predictor's copy is
        rebuilt with the int8 layers in it. A later export() carries the
        int8 graph into the artifact."""
        calibrate_quant(self.model, calibration_batches, sorter=self._maybe_sort)
        self._build_forwards()

    @classmethod
    def from_checkpoint(cls, path: str, config: ModelConfig, bf16: bool = False,
                        freeze_weights: bool = False, *, device="cuda") -> "Predictor":
        """Load the JAX package's trainer checkpoint (flax msgpack, plain or
        KD student layout, the EMA shadow where present) through
        utils/weights.py::from_jax_variables. bf16=True computes in bf16."""
        from lmsu_tpu_torch.utils.flax_checkpoint import load_model_variables
        from lmsu_tpu_torch.utils.weights import from_jax_variables
        if bf16:
            config = config.replace(compute_dtype=torch.bfloat16)
        sd = from_jax_variables(load_model_variables(path), config)
        return cls(config, sd, device=device, freeze_weights=freeze_weights)

    @classmethod
    def from_torch_checkpoint(cls, path: str, config: ModelConfig, *,
                              device="cuda", freeze_weights: bool = False) -> "Predictor":
        """Load a reference PyTorch .pth (trainer checkpoint with
        'model_state', or a bare state dict) or a saved port state dict."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return cls(config, ckpt.get("model_state", ckpt), device=device,
                   freeze_weights=freeze_weights)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return to_device(a, self.device, dtype)

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
            return self._served(images, self._tensor(points, torch.float32), pv)

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

    # -- serving export (torch.export) -------------------------------------

    def export(self, path: str, batch_size: int = 1, image_size: Optional[tuple] = None,
               num_points: int = 5000, with_point_valid: bool = True) -> None:
        """Write the forward as a self-contained serving artifact.

        The frozen model (models/frozen.py: BatchNorms folded, int8 layers
        quantised when quantize() ran) is traced by torch.export with the
        weights as constants of the graph, for float32 images [B, H, W, 3],
        float32 points [B, N, 4] and, unless with_point_valid=False, a bool
        point_valid [B, N]; torch.export.save writes it. The port's kernels
        are operators of the graph (ops/_cuda.py::define_op), traced on this
        Predictor's device and run there. The artifact also records its
        inputs and its scatter route, grid and range (ARTIFACT_META): a
        sorted-scatter model needs its points cell-sorted, which
        ServingEngine.from_exported does on the request threads.

        The guarantee is torch.export's: the artifact loads in the torch
        version that wrote it (torch.export's serialisation is not a
        versioned format as StableHLO is)."""
        hw = tuple(image_size or (256, 256))
        frozen = self._served if self._freeze_weights else freeze_model(self.model)
        args = (torch.zeros(batch_size, *hw, 3, device=self.device),
                torch.zeros(batch_size, num_points, 4, device=self.device))
        if with_point_valid:
            args += (torch.ones(batch_size, num_points, dtype=torch.bool, device=self.device),)
        with torch.no_grad():
            program = torch.export.export(_ServedForward(frozen), args, strict=False)
        program.example_inputs = None  # the traced zeros (6.6 MB at B=8, 256^2) need not ship
        lidar = self.config.lidar
        meta = {"batch_size": batch_size, "image_size": list(hw), "num_points": num_points,
                "with_point_valid": with_point_valid, "device": self.device.type,
                "scatter_impl": "pallas" if lidar.use_pallas else lidar.scatter_impl,
                "grid_size": list(lidar.grid_size),
                "point_cloud_range": [float(v) for v in lidar.point_cloud_range],
                "quantized": bool(quant_stats(self.model)), "torch": torch.__version__}
        torch.export.save(program, path, extra_files={ARTIFACT_META: json.dumps(meta)})


class _ServedForward(torch.nn.Module):
    """What an artifact records: the model's eval forward."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images, points, point_valid=None):
        return self.model(images, points, point_valid)


def _batch_inputs(batch):
    if isinstance(batch, dict):
        return batch["image"], batch["points"], batch.get("point_valid")
    return batch[0], batch[1], (batch[2] if len(batch) > 2 else None)


def calibrate_quant(model: torch.nn.Module, batches, sorter=None) -> Dict[str, torch.Tensor]:
    """Record each int8-eligible layer's activation absmax (ops/quant.py).

    Runs eval forwards of `model` (in eval mode) over `batches` (dicts with
    "image"/"points"[/"point_valid"], or tuples) inside
    models/layers.py::calibration, each eligible conv keeping the running
    max over all batches, after `sorter(points, point_valid)` where given.
    The stats are kept on the convs, outside the state dict; afterwards the
    model's eval forwards take the int8 path. Returns them by conv name
    (models/layers.py::quant_stats). Without a batch it raises and leaves
    the model as it was."""
    if model.training:
        raise ValueError("calibrate_quant needs the model in eval mode")
    dev = next(model.parameters()).device
    before = quant_stats(model)
    set_quant_stats(model, {})
    n = 0
    with torch.no_grad(), calibration():
        for batch in batches:
            img, pts, pv = _batch_inputs(batch)
            if sorter is not None:
                pts, pv = sorter(pts, pv)
            img = to_device(img, dev)
            if img.dtype != torch.uint8:
                img = img.float()
            pv = None if pv is None else to_device(pv, dev, torch.bool)
            model(img, to_device(pts, dev, torch.float32), pv)
            n += 1
    if n == 0:
        set_quant_stats(model, before)
        raise ValueError("calibrate_quant needs at least one batch")
    return quant_stats(model)


class ExportedForward:
    """A loaded artifact: `(images, points[, point_valid]) -> logits [B, h,
    w, num_classes]` on the artifact's device, numpy or tensors in. `meta`
    is what Predictor.export recorded; `program` the ExportedProgram."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.meta = meta
        self.device = torch.device(meta["device"])
        self._module = program.module()

    def __call__(self, images, points, point_valid=None) -> torch.Tensor:
        args = [to_device(images, self.device, torch.float32),
                to_device(points, self.device, torch.float32)]
        if self.meta["with_point_valid"]:
            if point_valid is None:
                raise ValueError("this artifact takes point_valid")
            args.append(to_device(point_valid, self.device, torch.bool))
        elif point_valid is not None:
            raise ValueError("this artifact was exported without point_valid")
        with torch.inference_mode():
            return self._module(*args)


def load_exported(path: str) -> ExportedForward:
    """Load a Predictor.export() artifact; returns a callable.

    The callable takes (images, points[, point_valid]) exactly as exported
    and returns logits [B, h, w, num_classes]. It needs no model code,
    config or checkpoint: only torch and the port's operators
    (lmsu_tpu_torch.ops, imported here, registers them), the counterpart of
    the JAX package's "just jax and the artifact". The artifact loads in the
    torch version that wrote it."""
    import lmsu_tpu_torch.ops  # noqa: F401  (registers the kernels' operators)
    extra = {ARTIFACT_META: ""}
    program = torch.export.load(path, extra_files=extra)
    return ExportedForward(program, json.loads(extra[ARTIFACT_META]))
