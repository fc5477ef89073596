"""The JAX package's trainer checkpoints (flax msgpack) served by the port:
utils/flax_checkpoint.py decodes them without msgpack or flax, leaf for leaf
as flax.serialization.msgpack_restore does, and Predictor.from_checkpoint
answers as the JAX package's Predictor.from_checkpoint on the plain, KD
({"model", "proj"}) and EMA layouts, within the parity bar (5e-4 of scale),
on the CPU at a small size."""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.inference import Predictor as JaxPredictor
from lmsu_tpu.training.checkpoint import save_checkpoint
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch import serve
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.inference import Predictor
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.utils import flax_checkpoint

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
IMG, NPTS, GRID = 32, 100, (8, 8)
LAYOUTS = ("plain", "kd", "ema")


def configs():
    kw = dict(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
              camera_fpn_channels=16)
    lid = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID)
    return (JModel(camera=JCam(base_channels=4), lidar=JLidar(**lid), **kw),
            ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                        lidar=LidarEncoderConfig(**lid), **kw))


def _variables(seed):
    """JAX variables from seeded port weights (randomised BN statistics,
    centred means) through the JAX package's converter: no JAX init."""
    jcfg, pcfg = configs()
    model = create_model(pcfg, seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.running_mean.normal_(0, 0.2, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
        model.lidar_encoder.encoder.point_mlp[-2].weight.mul_(0.05)
    return convert_torch_state_dict(model.state_dict(), jcfg)


@functools.lru_cache(maxsize=None)
def checkpoints(root: str):
    """One checkpoint of each layout under `root`, written by the JAX
    package's save_checkpoint: the trainer's state (step, params,
    batch_stats, opt_state, ema_params); KD's params {"model", "proj"};
    EMA's shadow with other weights than its params."""
    v, other = _variables(1), _variables(2)
    proj = {"camera_feat": np.ones((32, 16), np.float32)}
    states = {
        "plain": {"step": np.int32(5), "params": v["params"], "batch_stats": v["batch_stats"],
                  "opt_state": (), "ema_params": None},
        "kd": {"step": np.int32(7), "params": {"model": v["params"], "proj": proj},
               "batch_stats": v["batch_stats"], "opt_state": ()},
        "ema": {"step": np.int32(9), "params": other["params"], "ema_params": v["params"],
                "batch_stats": v["batch_stats"], "opt_state": ()}}
    paths = {}
    for name, state in states.items():
        d = Path(root) / name
        save_checkpoint(str(d), {"state": state}, epoch=4, val_miou=0.5)
        paths[name] = str(d / "latest.ckpt")
    return paths


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return checkpoints(str(tmp_path_factory.mktemp("ckpt")))


def inputs(seed=0):
    r = np.random.default_rng(seed)
    imgs = r.integers(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    pts = r.normal(0, 20, (2, NPTS, 4)).astype(np.float32)
    pts[..., 3] = r.uniform(0, 1, (2, NPTS))
    return imgs, pts


@pytest.mark.parametrize("layout", LAYOUTS)
def test_from_checkpoint_matches_jax(ckpts, layout):
    """The port's Predictor.from_checkpoint on a flax checkpoint answers as
    the JAX package's on the same file within 5e-4 of scale; the KD layout
    unwraps to its model, the EMA layout serves the shadow."""
    jcfg, pcfg = configs()
    imgs, pts = inputs(1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxPredictor.from_checkpoint(ckpts[layout], jcfg)(imgs, pts))
    got = Predictor.from_checkpoint(ckpts[layout], pcfg, device="cpu")(imgs, pts).numpy()
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()
    if layout == "ema":  # the shadow is the plain checkpoint's params
        plain = Predictor.from_checkpoint(ckpts["plain"], pcfg, device="cpu")
        np.testing.assert_array_equal(plain(imgs, pts).numpy(), got)


def test_from_checkpoint_bf16_and_frozen(ckpts):
    _, pcfg = configs()
    pred = Predictor.from_checkpoint(ckpts["plain"], pcfg, bf16=True, freeze_weights=True,
                                     device="cpu")
    assert pred.config.compute_dtype == torch.bfloat16 and pred._freeze_weights
    ref = Predictor.from_checkpoint(ckpts["plain"], pcfg, device="cpu")
    imgs, pts = inputs(2)
    a, b = pred(imgs, pts), ref(imgs, pts).numpy()
    assert a.dtype == torch.bfloat16
    assert np.abs(a.float().numpy() - b).max() <= 2e-2 * np.abs(b).max()


def _same_leaves(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_leaves(x, y, f"{path}/{i}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b or (a != a and b != b), path


def test_decoder_matches_flax_leaf_for_leaf(ckpts, monkeypatch):
    """Each checkpoint, and a tree of every msgpack type flax writes (ints
    of each width and sign, floats, nil, bools, str, bytes, lists, complex,
    numpy scalars, arrays of several dtypes, empty containers, a chunked
    array), decode as flax.serialization.msgpack_restore decodes them, bit
    for bit; a bfloat16 array decodes to its exact float32 values."""
    for path in ckpts.values():
        data = Path(path).read_bytes()
        _same_leaves(flax_checkpoint.msgpack_restore(data), serialization.msgpack_restore(data))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    r = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**40, 2**63 - 1],
        "floats": [0.0, -1.5, 1e300, float("inf"), float("nan")],
        "misc": [None, True, False, "", "é" * 40, "x" * 300, b"\x00\x01" * 200, [], {}],
        "complex": 1.5 - 2j,
        "scalars": [np.float32(1.25), np.int64(-3), np.bool_(True), np.uint8(7)],
        "arrays": {"f32": r.normal(size=(3, 4)).astype(np.float32),
                   "f64": r.normal(size=(2,)), "i8": np.arange(-4, 4, dtype=np.int8),
                   "u16": np.arange(10, dtype=np.uint16), "bool": np.array([True, False]),
                   "empty": np.zeros((0, 3), np.float32), "big": np.arange(100, dtype=np.int32),
                   "scalar0d": np.array(3.0, np.float32)},
        "map": {str(i): i for i in range(20)}}
    data = serialization.msgpack_serialize(tree)
    _same_leaves(flax_checkpoint.msgpack_restore(data), serialization.msgpack_restore(data))
    bf = jnp.asarray(r.normal(size=(2, 5)), jnp.bfloat16)
    got = flax_checkpoint.msgpack_restore(serialization.msgpack_serialize({"w": np.asarray(bf)}))
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], np.asarray(bf).astype(np.float32))


def test_reader_needs_neither_msgpack_nor_flax(ckpts):
    """With msgpack, flax and jax unimportable, the port reads a checkpoint
    and serves it."""
    code = (
        "import sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'lmsu_tpu'): sys.modules[m] = None\n"
        "import numpy as np\n"
        "from lmsu_tpu_torch.config import *\n"
        "from lmsu_tpu_torch.inference import Predictor\n"
        "from lmsu_tpu_torch.utils.flax_checkpoint import load_model_variables\n"
        f"path = {ckpts['kd']!r}\n"
        "v = load_model_variables(path)\n"
        "assert set(v) == {'params', 'batch_stats'} and 'proj' not in v['params']\n"
        "cfg = ModelConfig(num_classes=2, fusion_type='weighted', fusion_out_channels=16,\n"
        "    camera_fpn_channels=16, camera=CameraEncoderConfig(base_channels=4),\n"
        f"    lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16), grid_size={GRID}))\n"
        "out = Predictor.from_checkpoint(path, cfg, device='cpu')(\n"
        f"    np.zeros((1, {IMG}, {IMG}, 3), np.uint8), np.zeros((1, {NPTS}, 4), np.float32))\n"
        "assert tuple(out.shape) == (1, 8, 8, 2)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_serve_checkpoint_tells_flax_from_torch_by_content(ckpts, tmp_path, monkeypatch):
    """`serve --checkpoint` takes a flax .ckpt and a torch file alike, told
    apart by content (torch's are zip archives), whatever their names."""
    _, pcfg = configs()
    monkeypatch.setattr(serve, "build_config", lambda a: pcfg)
    flax_named_pth = tmp_path / "model.pth"
    flax_named_pth.write_bytes(Path(ckpts["plain"]).read_bytes())
    ref = Predictor.from_checkpoint(ckpts["plain"], pcfg, device="cpu")
    torch_named_ckpt = tmp_path / "model.ckpt"
    torch.save({"model_state": ref.model.state_dict()}, torch_named_ckpt)
    assert not flax_checkpoint.is_torch_file(str(flax_named_pth))
    assert flax_checkpoint.is_torch_file(str(torch_named_ckpt))
    imgs, pts = inputs(3)
    want = ref(imgs, pts).numpy()
    for path in (flax_named_pth, torch_named_ckpt):
        args = serve.parse_args(["--device", "cpu", "--checkpoint", str(path)])
        got = serve.load_predictor(args, pcfg)(imgs, pts).numpy()
        np.testing.assert_array_equal(got, want)
