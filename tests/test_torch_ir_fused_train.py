"""The port's fused InvertedResidual training path (ops/ir_fused.py:
fused_ir_train and the plain versions of its kernels K8-K13) against the
JAX package's fused_ir_train (Pallas, interpret mode on the CPU): each
kernel's outputs, the block's gradients, the module and the whole encoder
in train mode, the strict ReLU6 mask at ties, and one KD training step with
fused_train on both sides.

Tolerances. f32: forward 2e-5 absolute; gradients atol 1e-3 and rtol 1e-4
(tests/test_ir_fused.py:140-147: near-zero gradients come from cancelling
O(1) terms). bf16: both sides round to bf16 at the same places, but f32
summation order can move one intermediate across a rounding boundary, so a
few bf16 steps (2^-8 relative) at each output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_kd_step as kd
import torch
from test_torch_ir_fused import VARIANTS, _conv_bn_sd, _ir_state_dict, _jax_block

from lmsu_tpu.config import CameraEncoderConfig as JaxCameraConfig
from lmsu_tpu.models.camera_encoder import TwinLiteEncoder as JaxTwinLite
from lmsu_tpu.models.layers import InvertedResidual as JaxIR
from lmsu_tpu.ops import ir_fused as jir
from lmsu_tpu_torch.config import CameraEncoderConfig
from lmsu_tpu_torch.models.camera_encoder import TwinLiteEncoder
from lmsu_tpu_torch.models.layers import InvertedResidual
from lmsu_tpu_torch.ops import ir_fused as pir

torch.set_num_threads(2)

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _params(v, Cin):
    """The block's (w1, g1, be1, dwk, g2, be2, w2, g3, be3) as numpy, in the
    JAX layout; zeros for the expand triple at expansion 1."""
    p = v["params"]
    Ce = p["depthwise"]["conv"]["kernel"].shape[-1]
    if "expand" in p:
        w1 = p["expand"]["conv"]["kernel"][0, 0]
        g1, be1 = p["expand"]["bn"]["scale"], p["expand"]["bn"]["bias"]
    else:
        w1, g1, be1 = np.zeros((Cin, Ce)), np.zeros(Ce), np.zeros(Ce)
    out = (w1, g1, be1, p["depthwise"]["conv"]["kernel"][:, :, 0, :],
           p["depthwise"]["bn"]["scale"], p["depthwise"]["bn"]["bias"],
           p["project"]["conv"]["kernel"][0, 0], p["project"]["bn"]["scale"],
           p["project"]["bn"]["bias"])
    return [np.asarray(a, np.float32) for a in out]


def _close(got, want, dt, atol=2e-5, rtol=0.0):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dt == torch.bfloat16:
        atol = 4 * 2.0 ** -8 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _jax_run(x, params, stride, has_expand, dt_j, ct):
    ja = [jnp.asarray(x).astype(dt_j)] + [jnp.asarray(a) for a in params]
    out, stats, resid = jir._ir_train_forward(*ja, stride, has_expand, 1e-5)
    grads = jir._ir_train_backward(stride, has_expand, 1e-5, resid,
                                   (jnp.asarray(ct).astype(dt_j), None))
    return out, stats, resid, grads


@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_kernels_match_jax(rng, variant, dts):
    """K8 (stats of e), K9 (d and its stats), K10 (y_buf) and the block's
    output and statistics."""
    Cin, Cout, stride, exp, H = variant
    dt_j, dt_t = dts
    x, _, v = _jax_block(rng, *variant)
    params = _params(v, Cin)
    has_expand = exp != 1
    out, stats, resid, _ = _jax_run(x, params, stride, has_expand, dt_j,
                                    np.zeros((3, H // stride, H // stride, Cout), np.float32))
    d_want, y_want = jnp.concatenate(resid[1], axis=-1), resid[2]
    xt = torch.from_numpy(x).to(dt_t)
    tp = [torch.from_numpy(a) for a in params]
    M1 = xt.numel() // Cin
    if has_expand:
        m1, v1 = pir._bn_stats_finalize(*pir.stats1(xt, tp[0]), M1)
        _close(m1, stats[0], torch.float32, atol=1e-5, rtol=1e-5)
        _close(v1, stats[1], torch.float32, atol=1e-5, rtol=1e-5)
        s1, b1 = pir.fold_bn(tp[1], tp[2], m1, v1)
    d, s, sq = pir.expand_dw(xt, tp[0] if has_expand else None, *(
        (s1, b1) if has_expand else (None, None)), tp[3], stride)
    assert d.dtype == dt_t
    _close(d, d_want, dt_t)
    m2, v2 = pir._bn_stats_finalize(s, sq, d.numel() // d.shape[-1])
    _close(m2, stats[2], torch.float32, atol=1e-5 if dt_t == torch.float32 else 1e-3,
           rtol=1e-5)
    s2, b2 = pir.fold_bn(tp[4], tp[5], m2, v2)
    # K10 from the reference's own d and BN2 fold, so only K10 is compared.
    s2_ref, b2_ref = pir.fold_bn(tp[4], tp[5], torch.from_numpy(np.array(stats[2])),
                                 torch.from_numpy(np.array(stats[3])))
    d_ref = torch.from_numpy(np.array(d_want.astype(jnp.float32))).to(dt_t)
    _close(pir.proj(d_ref, s2_ref, b2_ref, tp[6]).to(dt_t), y_want, dt_t)
    got, got_stats = pir.fused_ir_train(xt, *tp, stride, has_expand, 1e-5)
    assert got.dtype == dt_t and len(got_stats) == 6
    _close(got, out, dt_t)
    for a, b in zip(got_stats, stats):
        _close(a, b, torch.float32, atol=1e-5 if dt_t == torch.float32 else 1e-2, rtol=1e-5)


@pytest.mark.parametrize("dts", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_backward_kernels_match_jax(rng, variant, dts):
    """K11-K13 through the block's backward: every gradient for a seeded
    cotangent, against _ir_train_backward."""
    Cin, Cout, stride, exp, H = variant
    dt_j, dt_t = dts
    x, _, v = _jax_block(rng, *variant)
    params = _params(v, Cin)
    ct = rng.normal(0, 1, (3, H // stride, H // stride, Cout)).astype(np.float32)
    _, _, _, grads = _jax_run(x, params, stride, exp != 1, dt_j, ct)
    xt = torch.from_numpy(x).to(dt_t).requires_grad_(True)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in params]
    out, _ = pir.fused_ir_train(xt, *tp, stride, exp != 1, 1e-5)
    out.backward(torch.from_numpy(ct).to(dt_t))
    got = [xt.grad] + [t.grad for t in tp]
    assert got[0].dtype == dt_t
    for name, g, w in zip(("x", "w1", "g1", "be1", "dw", "g2", "be2", "w2", "g3", "be3"),
                          got, grads):
        if dt_t == torch.float32:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4,
                                       err_msg=name)
        else:
            _close(g, w, dt_t)


def test_backward_kernel_outputs_match_jax_kernels(rng):
    """K11, K12 and K13 one by one against the Pallas kernels' own outputs
    (dv2, dW2 and the BN2 sums; dv1, dDW and the BN1 sums; dx and dW1) on
    the stride-2 variant, f32."""
    Cin, Cout, stride, exp, H = VARIANTS[0]
    x, _, v = _jax_block(rng, *VARIANTS[0])
    w1, g1, be1, dwk, g2, be2, w2, g3, be3 = _params(v, Cin)
    Ce = dwk.shape[-1]
    B, Ho = 3, H // stride
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    d = f(rng.normal(0, 1, (B, Ho, Ho, Ce)))
    dy = f(rng.normal(0, 1, (B, Ho, Ho, Cout)))
    vec = lambda lo=-0.5, hi=0.5: f(rng.uniform(lo, hi, Ce))  # noqa: E731
    s2, b2, m2, inv2 = vec(0.5, 1.5), vec(0, 3), vec(), vec(0.5, 1.5)
    want = jax.tree_util.tree_map(np.asarray, jir.pl.pallas_call(
        lambda *r: jir._proj_bwd_kernel(*r, Ho=Ho, Wo=Ho), grid=(B,),
        in_specs=[jir._bspec((B, Ho, Ho, Ce)), jir._bspec((B, Ho, Ho, Cout))]
        + [jir._vspec((1, Ce))] * 4 + [jir._vspec((Ce, Cout))],
        out_specs=[jir._bspec((B, Ho, Ho, Ce)), jir._vspec((Ce, Cout)), jir._vspec((1, Ce)),
                   jir._vspec((1, Ce))],
        out_shape=[jax.ShapeDtypeStruct((B, Ho, Ho, Ce), jnp.float32),
                   jax.ShapeDtypeStruct((Ce, Cout), jnp.float32),
                   jax.ShapeDtypeStruct((1, Ce), jnp.float32),
                   jax.ShapeDtypeStruct((1, Ce), jnp.float32)],
        scratch_shapes=[jir.pltpu.VMEM((Ce, Cout), jnp.float32),
                        jir.pltpu.VMEM((1, Ce), jnp.float32), jir.pltpu.VMEM((1, Ce), jnp.float32)],
        interpret=True)(d, dy, s2[None], b2[None], m2[None], inv2[None], w2))
    t = torch.from_numpy
    got = pir.proj_bwd(t(d), t(dy), t(s2), t(b2), t(m2), t(inv2), t(w2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().reshape(w.shape), w, atol=1e-4, rtol=1e-5)

    dv2 = got[0]
    u2, p2, q2 = vec(0.5, 1.5), vec(), vec()
    s1, b1, m1, inv1 = vec(0.5, 1.5), vec(0, 3), vec(), vec(0.5, 1.5)
    want = jax.tree_util.tree_map(np.asarray, jir.pl.pallas_call(
        lambda *r: jir._dw_bwd_kernel(*r, H=H, W=H, stride=stride, has_expand=True), grid=(B,),
        in_specs=[jir._bspec((B, H, H, Cin)), jir._vspec((Cin, Ce))] + [jir._vspec((1, Ce))] * 4
        + [jir._vspec((3, 3, Ce)), jir._bspec((B, Ho, Ho, Ce))] + [jir._vspec((1, Ce))] * 3
        + [jir._bspec((B, Ho, Ho, Ce)), jir._vspec((1, Ce)), jir._vspec((1, Ce))],
        out_specs=[jir._bspec((B, H, H, Ce)), jir._vspec((9, Ce)), jir._vspec((1, Ce)),
                   jir._vspec((1, Ce))],
        out_shape=[jax.ShapeDtypeStruct((B, H, H, Ce), jnp.float32),
                   jax.ShapeDtypeStruct((9, Ce), jnp.float32),
                   jax.ShapeDtypeStruct((1, Ce), jnp.float32),
                   jax.ShapeDtypeStruct((1, Ce), jnp.float32)],
        scratch_shapes=[jir.pltpu.VMEM((9, Ce), jnp.float32), jir.pltpu.VMEM((1, Ce), jnp.float32),
                        jir.pltpu.VMEM((1, Ce), jnp.float32)],
        interpret=True)(x, w1, s1[None], b1[None], m1[None], inv1[None], dwk, dv2.numpy(),
                        u2[None], p2[None], q2[None], d, m2[None], inv2[None]))
    got = pir.dw_bwd(t(x), t(w1), t(s1), t(b1), t(m1), t(inv1), t(dwk), dv2, t(u2), t(p2),
                     t(q2), t(d), t(m2), t(inv2), stride)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().reshape(w.shape), w, atol=1e-4, rtol=1e-5)

    dv1 = got[0]
    u1, p1, q1 = vec(0.5, 1.5), vec(), vec()
    want = jax.tree_util.tree_map(np.asarray, jir.pl.pallas_call(
        lambda *r: jir._expand_bwd_kernel(*r, H=H, W=H), grid=(B,),
        in_specs=[jir._bspec((B, H, H, Cin)), jir._vspec((Cin, Ce))] + [jir._vspec((1, Ce))] * 5
        + [jir._bspec((B, H, H, Ce))],
        out_specs=[jir._bspec((B, H, H, Cin)), jir._vspec((Cin, Ce))],
        out_shape=[jax.ShapeDtypeStruct((B, H, H, Cin), jnp.float32),
                   jax.ShapeDtypeStruct((Cin, Ce), jnp.float32)],
        scratch_shapes=[jir.pltpu.VMEM((Cin, Ce), jnp.float32)],
        interpret=True)(x, w1, m1[None], inv1[None], u1[None], p1[None], q1[None], dv1.numpy()))
    got = pir.expand_bwd(t(x), t(w1), t(m1), t(inv1), t(u1), t(p1), t(q1), dv1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-5)


def test_relu6_ties_get_derivative_zero(rng):
    """A BN output exactly at 0 or 6 gets ReLU6 derivative 0 on the fused
    path, as the JAX package's fused kernels give (their masks are strict);
    the unfused path's ReLU6 splits it (1/2). BN1 on channels 0-3 and BN2 on
    channels 4-7 get gamma 0 and beta 0 or 6, which puts every position of
    those channels on a tie."""
    Cin, Cout, stride, exp, H = VARIANTS[1]
    x, _, v = _jax_block(rng, *VARIANTS[1])
    params = _params(v, Cin)
    tied = {2: slice(0, 4), 5: slice(4, 8)}  # be1, be2 -> their tied channels
    for bi, sl in tied.items():
        params[bi - 1][sl] = 0.0
        params[bi][sl] = np.array([0.0, 0.0, 6.0, 6.0], np.float32)
    ct = rng.normal(0, 1, (3, H, H, Cout)).astype(np.float32)
    _, _, _, grads = _jax_run(x, params, stride, True, jnp.float32, ct)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in params]
    out, _ = pir.fused_ir_train(torch.from_numpy(x), *tp, stride, True, 1e-5)
    out.backward(torch.from_numpy(ct))
    # The BN's gamma and beta gradients are sums of dv (times the normalised
    # input) over positions: exactly 0 where every position is masked.
    for bi, sl in tied.items():
        for i in (bi - 1, bi):
            assert np.asarray(grads[i + 1])[sl].tolist() == [0.0] * 4  # grads[0] is dx
            assert tp[i].grad[sl].tolist() == [0.0] * 4
            assert tp[i].grad.abs().max() > 0
    # The unfused module on the same weights gives the ties 1/2, and those
    # channels' gamma gradients are no longer 0.
    block = InvertedResidual(Cin, Cout, stride, exp).train()
    block.load_state_dict(_ir_state_dict(*_tied_variables(v, params)), strict=True)
    y = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    for bn, sl in ((block.conv[1], tied[2]), (block.conv[4], tied[5])):
        assert bn.weight.grad[sl].abs().max() > 1e-3


def _tied_variables(v, params):
    p = jax.tree_util.tree_map(np.array, v["params"])
    p["expand"]["bn"]["scale"], p["expand"]["bn"]["bias"] = params[1], params[2]
    p["depthwise"]["bn"]["scale"], p["depthwise"]["bn"]["bias"] = params[4], params[5]
    return p, v["batch_stats"]


def test_odd_spatial_at_stride_2_raises(rng):
    Cin, Cout, stride, exp, H = VARIANTS[0]
    x, _, v = _jax_block(rng, *VARIANTS[0])
    tp = [torch.from_numpy(a) for a in _params(v, Cin)]
    with pytest.raises(ValueError, match="even spatial dims"):
        pir.fused_ir_train(torch.from_numpy(x[:, :15, :15]), *tp, 2, True, 1e-5)


def test_wrappers_refuse_mismatched_shapes():
    """The kernels read by the shapes they are given: each wrapper checks
    its operands against x (or d) before choosing a path."""
    x, d = torch.zeros(2, 4, 4, 8), torch.zeros(2, 4, 4, 16)
    w1, dw, w2, v = torch.zeros(8, 16), torch.zeros(3, 3, 16), torch.zeros(16, 8), torch.zeros(16)
    bad = {
        "stats1": lambda: pir.stats1(x, torch.zeros(4, 16)),
        "expand_dw": lambda: pir.expand_dw(x, w1, v, v, torch.zeros(3, 3, 8), 1),
        "proj": lambda: pir.proj(d, v, torch.zeros(8), w2),
        "proj_bwd": lambda: pir.proj_bwd(d, torch.zeros(2, 4, 4, 4), v, v, v, v, w2),
        "dw_bwd": lambda: pir.dw_bwd(x, w1, v, v, v, v, dw, d, v, v, v, d[:, :2], v, v, 1),
        "expand_bwd": lambda: pir.expand_bwd(x, w1, v, v, v, v, torch.zeros(8), d),
    }
    for name, call in bad.items():
        with pytest.raises(ValueError, match=name):
            call()


def _grads_state_dict(grads, stats, prefix=""):
    """JAX parameter gradients in the port's state-dict names."""
    return {k: t for k, t in _ir_state_dict(grads, stats, prefix).items()
            if k.endswith(("weight", "bias"))}


@pytest.mark.parametrize("variant", VARIANTS)
def test_module_train_step_matches_jax(rng, variant):
    """InvertedResidual(fused_train=True) in train mode against the JAX
    module with fused_train: output, running statistics after the step and
    every parameter gradient of sum(sin(out))."""
    Cin, Cout, stride, exp, H = variant
    x, _, v = _jax_block(rng, *variant)
    mod = JaxIR(Cout, (stride, stride), expansion_ratio=exp, fused_train=True)

    def loss(params):
        o, mut = mod.apply({"params": params, "batch_stats": v["batch_stats"]},
                           jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(o)), (o, mut["batch_stats"])

    (_, (want, new_stats)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    block = InvertedResidual(Cin, Cout, stride, exp, fused_train=True).train()
    block.load_state_dict(_ir_state_dict(v["params"], v["batch_stats"]), strict=True)
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=2e-5)
    out.sin().sum().backward()
    sd = block.state_dict()
    for k, w in _ir_state_dict(v["params"], new_stats).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k
    params = dict(block.named_parameters())
    for k, w in _grads_state_dict(g, v["batch_stats"]).items():
        np.testing.assert_allclose(params[k].grad.numpy(), w.numpy(), atol=1e-3, rtol=1e-4,
                                   err_msg=k)


def test_module_fused_matches_unfused_port(rng):
    """The fused block and the port's unfused block (cuDNN-style convs and
    train-mode BatchNorm) agree on the output and running statistics."""
    Cin, Cout, stride, exp, H = VARIANTS[1]
    x, _, v = _jax_block(rng, *VARIANTS[1])
    outs, sds = [], []
    for fused in (True, False):
        block = InvertedResidual(Cin, Cout, stride, exp, fused_train=fused).train()
        block.load_state_dict(_ir_state_dict(v["params"], v["batch_stats"]), strict=True)
        outs.append(block(torch.from_numpy(x).permute(0, 3, 1, 2)).detach())
        sds.append(block.state_dict())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=2e-5)
    for k in sds[0]:
        np.testing.assert_allclose(sds[0][k].float().numpy(), sds[1][k].float().numpy(),
                                   atol=1e-5, err_msg=k)


def test_eval_mode_is_unchanged(rng):
    Cin, Cout, stride, exp, H = VARIANTS[0]
    x, mod, v = _jax_block(rng, *VARIANTS[0])
    want = np.asarray(mod.apply(v, jnp.asarray(x), train=False))
    block = InvertedResidual(Cin, Cout, stride, exp, fused_train=True).eval()
    block.load_state_dict(_ir_state_dict(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_whole_encoder_train_step_matches_jax(rng):
    """TwinLite (quarter width) with fused_train: every stage's output, the
    running statistics after the step and every parameter gradient against
    the JAX encoder with fused_train (tests/test_ir_fused.py:149-180)."""
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    enc = JaxTwinLite(JaxCameraConfig(base_channels=8, fused_train=True))
    v = enc.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(0, 1, a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])

    def loss(params):
        o, mut = enc.apply({"params": params, "batch_stats": v["batch_stats"]},
                           jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(jnp.sin(t)) for t in o.values()), (o, mut["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (want, new_stats)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v["params"])

    def port_sd(p, s):
        sd = {}
        _conv_bn_sd(sd, "stem.0", "stem.1", p["stem"], s["stem"])
        for k in range(1, 6):
            sd.update(_ir_state_dict(p[f"stage{k}"], s[f"stage{k}"], f"stage{k}."))
        return sd

    port = TwinLiteEncoder(CameraEncoderConfig(base_channels=8, fused_train=True)).train()
    port.load_state_dict(port_sd(v["params"], v["batch_stats"]), strict=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in want:
        np.testing.assert_allclose(got[k].detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), atol=1e-4, rtol=1e-5, err_msg=k)
    sum(t.sin().sum() for t in got.values()).backward()
    sd = port.state_dict()
    for k, w in port_sd(v["params"], new_stats).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5, err_msg=k)
    params = dict(port.named_parameters())
    wg = port_sd(g, v["batch_stats"])
    assert set(params) <= set(wg)
    # Gradient magnitudes are O(100) here: atol 5e-3 pins ~1e-5 relative
    # (tests/test_ir_fused.py:173-180).
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), wg[k].numpy(), atol=5e-3, rtol=1e-4,
                                   err_msg=k)


# -- one KD training step with fused_train on both sides ---------------------


@pytest.fixture(scope="module")
def jax_kd_run():
    """bench.py's KD step at the test size of tests/test_torch_kd_step.py,
    with CameraEncoderConfig(fused_train=True): STEPS steps from the initial
    weights, and the same from weights moved by 1e-6 of themselves (the
    reference's own spread)."""
    return kd._jax_trajectory("sorted_pallas", fused_train=True)


def test_kd_steps_with_fused_train_match_jax(jax_kd_run, tmp_path):
    """DistillationTrainer.train_step with CameraEncoderConfig(fused_train=
    True) against the JAX package's KD step with the same flag, held to
    tests/test_torch_kd_step.py's protocol (its docstring): each quantity to
    a fixed margin plus min(10 N, cap), N the reference's spread under a
    1e-6 weight perturbation; per kind, the port needs the noise term no
    more often than the reference's spread exceeds the fixed margin."""
    tr = kd.hold_kd_steps(jax_kd_run, tmp_path, "in_loop", "sorted_pallas", fused_train=True)
    assert tr.model.camera_encoder.stage2.fused_train
