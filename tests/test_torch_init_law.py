"""The port's seeded initialisation against flax's laws, on the CPU.

models/factory.py::create_model draws each weight with the law of the flax
initialiser that its JAX counterpart has (utils/weights.py::kernel_table):
conv_init, variance_scaling(2, "fan_out", "truncated_normal"), for every
conv, the x4 head's transposed convs and the gate's kernels; flax's Dense
default lecun_normal, variance_scaling(1, "fan_in", "truncated_normal"),
for the point MLP and the pillar net. The two packages' RNGs differ, so the
values differ; the laws are held by moments, at full width, for weighted/128,
its 2x teacher, concat/256 with the x4 head and the PointPillars student:

  * no value beyond the truncation bound, 2 stds of the normal before the
    cut (exact, in float32);
  * the std within 4 / sqrt(2 n) of the law's, sqrt(scale / fan), relative
    (n the element count; 0.1 relative where n < 64);
  * the JAX package's own seed-0 draw, carried over by from_jax_variables,
    passes the same bar (so the table names flax's law for each weight);
  * biases zero, BatchNorm at identity;
  * create_model(cfg, seed=s) twice is bit-equal, the x4 head included,
    and leaves torch's global RNG as it was; two seeds differ in every
    drawn tensor.
"""

import dataclasses
import functools
import math

import pytest
import torch
from test_torch_model import _init_plain

from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.config import teacher_config as jax_teacher_config
from lmsu_tpu_torch.config import ModelConfig, teacher_config
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.utils.weights import TRUNC_STD, from_jax_variables, init_std, kernel_table

torch.set_num_threads(2)


def _weighted(cls):
    return cls(fusion_type="weighted", fusion_out_channels=128)


def _pillars(cls):
    m = _weighted(cls)
    return m.replace(lidar=dataclasses.replace(m.lidar, encoder_type="pointpillars"))


CONFIGS = {
    "weighted128": lambda: (_weighted(ModelConfig), _weighted(JModel)),
    "teacher2x": lambda: (teacher_config(_weighted(ModelConfig)),
                          jax_teacher_config(_weighted(JModel))),
    "concat256_x4": lambda: (ModelConfig(output_mode="x4"), JModel(output_mode="x4")),
    "pillars128": lambda: (_pillars(ModelConfig), _pillars(JModel)),
}


@functools.lru_cache(maxsize=None)
def port_state(name, seed=0):
    cfg, _ = CONFIGS[name]()
    return {k: v.detach().clone() for k, v in create_model(cfg, seed=seed).state_dict().items()}


def check_law(sd, cfg):
    """Every weight of kernel_table(cfg) in `sd` within its law's truncation
    bound and std bar; its bias zero and its BatchNorm at identity. Returns
    the number of weights checked."""
    table = kernel_table(cfg)
    for name, k in table.items():
        w = sd[f"{name}.weight"].double()
        std = init_std(k.init, tuple(w.shape))
        bound = torch.tensor(2 * std / TRUNC_STD, dtype=torch.float32).double()
        assert w.abs().max() <= bound, (name, w.abs().max().item(), bound.item())
        n = w.numel()
        tol = 0.1 if n < 64 else 4 / math.sqrt(2 * n)
        got = w.std().item()
        assert abs(got / std - 1) <= tol, (name, k.init, got, std, tol)
        if f"{name}.bias" in sd:
            assert not sd[f"{name}.bias"].any(), name
        if k.bn is not None:
            bn = k.bn[0]
            assert torch.equal(sd[f"{bn}.weight"], torch.ones_like(sd[f"{bn}.weight"])), bn
            for part in ("bias", "running_mean"):
                assert not sd[f"{bn}.{part}"].any(), (bn, part)
            assert torch.equal(sd[f"{bn}.running_var"], torch.ones_like(sd[f"{bn}.running_var"]))
    return len(table)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_draw_follows_flax_law(name):
    """Every floating parameter of the port's seed-0 model has a flax
    counterpart in kernel_table (weights, biases, BatchNorm), and each
    weight follows its law; the point MLP's first layer (lecun_normal,
    fan-in 4: std 0.5) by name."""
    cfg, _ = CONFIGS[name]()
    sd = port_state(name)
    table = kernel_table(cfg)
    covered = {f"{n}.weight" for n in table} | {f"{n}.bias" for n, k in table.items() if k.bias}
    covered |= {f"{k.bn[0]}.{p}" for k in table.values() if k.bn for p in ("weight", "bias")}
    params = {n for n, p in create_model(cfg).named_parameters()}
    assert params == covered
    assert check_law(sd, cfg) == len(table)
    if name == "weighted128":
        assert abs(sd["lidar_encoder.encoder.point_mlp.0.weight"].std().item() - 0.5) < 0.05


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_draw_passes_the_same_bar(name):
    """The JAX package's seed-0 initial variables (jitted init, cached per
    configuration), carried over by from_jax_variables, pass check_law:
    the table's initialiser is the one flax draws each weight with."""
    cfg, jcfg = CONFIGS[name]()
    sd = from_jax_variables(_init_plain(jcfg, 0), cfg)
    assert set(sd) == set(port_state(name))
    assert check_law(sd, cfg) == len(kernel_table(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_seed_fixes_every_parameter(name):
    """create_model(cfg, seed=0) twice gives the same bits in every tensor
    (the x4 head's transposed convs included) and leaves the global RNG as
    it was; seed 1 differs from seed 0 in every drawn weight."""
    cfg, _ = CONFIGS[name]()
    state = torch.get_rng_state()
    again = create_model(cfg, seed=0).state_dict()
    first = port_state(name)
    assert set(again) == set(first)
    for k, v in first.items():
        assert torch.equal(again[k], v), k
    assert torch.equal(torch.get_rng_state(), state)
    other = port_state(name, seed=1)
    for n in kernel_table(cfg):
        assert not torch.equal(other[f"{n}.weight"], first[f"{n}.weight"]), n


def test_transposed_conv_fan_out_matches_jax_std():
    """The x4 head's transposed convs at concat/256: the law's std is JAX's
    measured 0.0221 / 0.0442 (fan-out kh kw cin on flax's [kh, kw, out, in]
    kernel)."""
    sd = port_state("concat256_x4")
    for key, cin, want in (("head.up1.0.weight", 256, 0.0221), ("head.up2.0.weight", 64, 0.0442)):
        std = init_std("conv_init", tuple(sd[key].shape))
        assert std == pytest.approx(math.sqrt(2 / (4 * 4 * cin)))
        assert std == pytest.approx(want, abs=5e-5)
