"""Ensemble teachers of the port's DistillationTrainer (EnsembleTeacher), on
the CPU, at the JAX package's tiny KD size (tests/test_kd_ensemble.py::
_tiny_cfg: concat/32 student, 2x teacher members, 32^2 images, 128 points,
8x8 grid, 8 samples in one batch).

  * K = 1 is the single teacher bit for bit: the wrapper returns the
    member's output, and a one-element list of state dicts trains as the
    state dict alone;
  * K = 2 averages every member's logits and taps as the JAX package's
    EnsembleTeacher does, each member's weights carried across by the JAX
    package's converter (f32; within 1e-5 of scale);
  * members load from the port's .pth files (KDConfig.teacher_checkpoints);
  * a single state dict for a K > 1 ensemble raises;
  * a cached ensemble trains as the in-loop ensemble (same process, same
    ops: no tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.training.distill import EnsembleTeacher as JaxEnsembleTeacher
from lmsu_tpu.utils.torch_compat import convert_torch_state_dict
from lmsu_tpu_torch.common import build_loaders
from lmsu_tpu_torch.config import (CameraEncoderConfig, DataConfig, ExperimentConfig,
                                   KDConfig, LidarEncoderConfig, ModelConfig, TrainConfig,
                                   teacher_config)
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.training import DistillationTrainer
from lmsu_tpu_torch.training.distill import EnsembleTeacher

torch.set_num_threads(2)

TAPS = ("camera_feat", "post_fusion")
MODEL = dict(num_classes=2, fusion_type="concat", fusion_out_channels=32,
             camera_fpn_channels=16)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _config(save_dir, **kd):
    model = ModelConfig(camera=CameraEncoderConfig(base_channels=4),
                        lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                 grid_size=(8, 8)), **MODEL)
    data = DataConfig(image_size=(32, 32), grid_size=(8, 8), max_points=128, batch_size=8,
                      synthetic_num_train=8, synthetic_num_val=8, num_workers=0)
    train = TrainConfig(num_epochs=1, class_weights=(0.4, 3.5), save_dir=str(save_dir),
                        kd=KDConfig(enabled=True, feature_taps=TAPS, **kd))
    return ExperimentConfig(model=model, data=data, train=train)


def _trainer(save_dir, teacher_state_dict=None, **kd):
    cfg = _config(save_dir, **kd)
    return DistillationTrainer(cfg, *build_loaders(cfg, verbose=False), device="cpu",
                               teacher_state_dict=teacher_state_dict)


def _member_states(k):
    """K teacher members' state dicts, drawn as the trainer draws random
    members (seed + 1 + i), with randomised BatchNorm statistics."""
    tcfg = teacher_config(_config("").model, 2.0)
    out = []
    for i in range(k):
        sd = create_model(tcfg, seed=1 + i).state_dict()
        gen = torch.Generator().manual_seed(10 + i)
        for name, v in sd.items():
            if name.endswith("running_mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            elif name.endswith("running_var"):
                v.copy_(0.5 + torch.rand(v.shape, generator=gen))
        out.append(sd)
    return out


def test_k1_is_the_single_teacher_bit_for_bit(rng, tmp_path):
    sd, = _member_states(1)
    member = create_model(teacher_config(_config("").model, 2.0))
    member.load_state_dict(sd)
    member.eval()
    img = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.normal(0, 20, (2, 128, 4)).astype(np.float32))
    with torch.no_grad():
        logits, taps = EnsembleTeacher([member])(img, pts, return_intermediates=True)
        want_logits, want_taps = member(img, pts, return_intermediates=True)
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(taps[k], want_taps[k]) for k in want_taps)

    single = _trainer(tmp_path / "single", sd)
    listed = _trainer(tmp_path / "listed", [sd], ensemble_size=1)
    assert single.num_teachers == listed.num_teachers == 1
    assert not isinstance(listed.teacher, EnsembleTeacher)
    assert single.train_epoch()[0] == listed.train_epoch()[0]
    assert all(torch.equal(p, q) for p, q in zip(single.params.values(),
                                                 listed.params.values()))


def test_k2_means_match_jax_ensemble(rng):
    states = _member_states(2)
    jstudent = JModel(camera=JCam(base_channels=4),
                      lidar=JLidar(feature_dim=16, mlp_dims=(8, 16), grid_size=(8, 8)), **MODEL)
    jcfg = jax_teacher_config(jstudent, 2.0)
    variables = tuple(jax.tree_util.tree_map(jnp.asarray, convert_torch_state_dict(sd, jcfg))
                      for sd in states)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    pts = rng.normal(0, 20, (2, 128, 4)).astype(np.float32)
    ens = JaxEnsembleTeacher(jax_create_model(jcfg), 2)
    want_logits, want_taps = jax.jit(lambda v, i, p: ens.apply(
        v, i, p, train=False, return_intermediates=True))({"members": variables}, img, pts)

    members = []
    for sd in states:
        m = create_model(teacher_config(_config("").model, 2.0))
        m.load_state_dict(sd)
        members.append(m.eval())
    with torch.no_grad():
        logits, taps = EnsembleTeacher(members)(torch.from_numpy(img), torch.from_numpy(pts),
                                                return_intermediates=True)
        one = members[0](torch.from_numpy(img), torch.from_numpy(pts))

    def close(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    close(logits.numpy(), want_logits)
    assert not torch.allclose(logits, one)  # the mean is not one member's output
    for k, v in taps.items():
        close(v.numpy() if v.dim() < 4 or k == "logits" else v.permute(0, 2, 3, 1).numpy(),
              want_taps[k])


def test_members_load_from_checkpoints(tmp_path):
    states = _member_states(2)
    paths = []
    for i, sd in enumerate(states):
        paths.append(str(tmp_path / f"teacher{i}.pth"))
        torch.save({"model_state": sd, "epoch": 0}, paths[-1])
    tr = _trainer(tmp_path, teacher_checkpoints=tuple(paths))
    assert isinstance(tr.teacher, EnsembleTeacher) and tr.num_teachers == 2
    for m, sd in zip(tr.teacher.members, states):
        assert all(torch.equal(m.state_dict()[k], v) for k, v in sd.items())
    random = _trainer(tmp_path, ensemble_size=3)
    assert len(random.teacher.members) == 3
    first = random.teacher.members[0].state_dict()
    assert all(torch.equal(first[k], v)  # member 0 is the single teacher's draw
               for k, v in _trainer(tmp_path).teacher.state_dict().items())


def test_member_count_mismatch_raises(tmp_path):
    sd, = _member_states(1)
    with pytest.raises(ValueError, match="2 ensemble members"):
        _trainer(tmp_path, sd, ensemble_size=2)
    with pytest.raises(ValueError, match="2 ensemble members"):
        _trainer(tmp_path, sd, teacher_checkpoints=("a.pth", "b.pth"))
    with pytest.raises(ValueError, match="ensemble_size"):
        _trainer(tmp_path, ensemble_size=0)
    with pytest.raises(ValueError, match="member"):
        EnsembleTeacher([])


def test_cached_ensemble_equals_in_loop_ensemble(tmp_path):
    states = _member_states(2)
    in_loop = _trainer(tmp_path / "a", states)
    cached = _trainer(tmp_path / "b", states, cache_teacher=True)
    want, got = in_loop.train_epoch(), cached.train_epoch()
    assert cached.teacher_cache is not None
    assert got[0] == want[0] and got[1]["miou"] == want[1]["miou"]
    assert all(torch.equal(p, q) for p, q in zip(cached.params.values(),
                                                 in_loop.params.values()))
