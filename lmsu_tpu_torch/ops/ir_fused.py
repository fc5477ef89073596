"""Fused InvertedResidual blocks: the hand-written CUDA kernels and their
plain PyTorch versions, for inference and for training.

Inference (`fused_ir_infer`, csrc/ir_fused_infer.cu) replaces the TPU kernel
lmsu_tpu/ops/ir_fused.py::_ir_infer_kernel (with the chunk loop and glue of
fused_ir_infer). With BN running statistics folded into per-channel
scale/bias:

    e   = relu6((x @ W1) * s1 + b1)           expand 1x1 (absent at expansion 1)
    d   = relu6(dw3x3(e, stride) * s2 + b2)   depthwise, padding 1
    out = (d @ W2) * s3 + b3  (+ x if stride 1 and Cin == Cout)

The kernel runs both 1x1 products on the tensor cores (the training
kernels' split-operand mma_step, W1 and W2 as pre-split fragments built
once per folded-parameter set) and the depthwise on CUDA cores, keeping the
6x-expanded hidden tensor in shared memory, the whole block in one launch
(see the .cu source note). Rounding follows the TPU kernel, not the
training path: relu6(e * s1 + b1) is rounded to the input dtype but e
itself is not, the depthwise taps and d are rounded, every sum is f32, and
the residual is added in the input dtype (`fused_ir_infer_emulated`
repeats the kernel's arithmetic for the tests).

Training (`fused_ir_train`, an autograd Function) transcribes
_ir_train_forward / _ir_train_backward. BatchNorm needs the batch
statistics before it normalises, so the forward is three kernels with
[C]-vector glue between them, and the backward three more:

    K8  stats1      e = x @ W1 (the shared expand), never stored -> mean1/var1
    K9  expand_dw   recompute e, BN1 + relu6, depthwise; STORE d -> mean2/var2
    K10 proj        BN2 + relu6, y = d' @ W2
    glue            BN3 statistics, out = BN3(y) (+ x)
    glue            BN3 backward -> dy
    K11 proj_bwd    dW2 = d'^T dy; dv2 = relu6'(v2) (dy W2^T); STORE dv2; sums
    K12 dw_bwd      dd = BN2bwd(dv2); dDW tap sums; de' = conv_T(dd, DW);
                    dv1 = relu6'(v1) de' (e recomputed); STORE dv1; sums
    K13 expand_bwd  de = BN1bwd(dv1); dW1 = x^T de; dx = de W1^T (+ dout)

(csrc/ir_train_*.cu; K8-K13 number the TPU kernels as PERF.md does.) The
numerics contract is the TPU module's (its docstring, :33-60): BN
statistics are the fast variance E[x^2] - E[x]^2 in f32, not
F.batch_norm's; values are rounded to the input dtype at the TPU kernels'
places (e after the expand dot, e_act, the depthwise taps, the stored d,
d_act, y_buf, dy, the stored dv2, dd, the stored dv1, de), dx is summed in
f32 and cast once; the ReLU6 derivative is 1 strictly inside (0, 6) and 0
at the ties (the TPU kernels' masks; the unfused path's ReLU6 gives 1/2
there); the residual is added in the input dtype. The TPU path pads the
hidden dim to 128 lanes and loops over 128-wide chunks; the padded
channels are exactly zero, so leaving both out changes only the order of
f32 sums. Each kernel has a plain version here (`*_plain`): CPU tensors
take it, CUDA tensors launch the kernel, other devices raise.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lmsu_tpu_torch.ops._cuda import (_I, _L, _P, CudaKernel, aligned16, check_cuda_args,
                                      check_device, define_op, dtype_code, ptr, stream_ptr)
from lmsu_tpu_torch.ops.kd_loss import split_bf16
from lmsu_tpu_torch.parallel.mesh import all_reduce_, data_mesh

KERNEL = CudaKernel("ir_fused_infer.cu", {
    "ir_fused_infer": (_P,) * 11 + (_I,) * 14 + (_P,),
    "ir_fused_infer_plan": (_I,) * 9 + (_P,)})

_SMEM_LIMIT = 232448          # shared memory a block may opt in to on Hopper


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BN(stats) == x * scale + bias, with rsqrt as the JAX package folds."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


class IRParams(NamedTuple):
    """Folded block parameters, in the JAX package's layout: w1 [Cin, Ce]
    (None at expansion 1), dw [3, 3, Ce], w2 [Ce, Cout]; scales and biases
    per channel."""
    w1: Optional[torch.Tensor]
    s1: Optional[torch.Tensor]
    b1: Optional[torch.Tensor]
    dw: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def fused_ir_infer_plain(x: torch.Tensor, p: IRParams, stride: int) -> torch.Tensor:
    """Plain version: x [B, H, W, Cin] NHWC -> [B, Ho, Wo, Cout]."""
    dt = x.dtype
    Cin, Cout = x.shape[-1], p.w2.shape[-1]
    if p.w1 is not None:
        e = x.float() @ p.w1.to(dt).float()
        e_act = _relu6(e * p.s1.float() + p.b1.float()).to(dt)
    else:
        e_act = x
    ce = e_act.shape[-1]
    dw = p.dw.to(dt).float().permute(2, 0, 1).unsqueeze(1)          # [Ce, 1, 3, 3]
    d = F.conv2d(e_act.float().permute(0, 3, 1, 2), dw, stride=stride, padding=1,
                 groups=ce).permute(0, 2, 3, 1)
    d = _relu6(d * p.s2.float() + p.b2.float()).to(dt)
    y = d.float() @ p.w2.to(dt).float()
    out = (y * p.s3.float() + p.b3.float()).to(dt)
    if stride == 1 and Cin == Cout:
        out = x + out
    return out


def _row_ld(c: int, es: int) -> int:
    """csrc/ir_train_common.cuh::row_ld: a staged row of c channels."""
    per = 128 // es
    return -(-(-(-c // 16) * 16) // per) * per


def _smem_bytes(stride: int, cin: int, cout: int) -> int:
    """The least shared memory K3 needs for a block: f32 at its smallest
    output tile, 4x8 (csrc/ir_fused_infer.cu::layout_of): the halo's three
    bf16 term planes with a zero row, one 32-channel chunk of e in f32 and
    of d in three bf16 terms, and the chunk's 13 per-channel vectors."""
    pin = (3 * stride + 3) * (7 * stride + 3)
    return 6 * (pin + 1) * _row_ld(cin, 2) + 4 * pin * 32 + 6 * 32 * 32 + 4 * 13 * 32


def fused_infer_limits(cin: int, ce: int, cout: int, stride: int) -> list:
    """What K3 cannot take for a block with these widths (empty when it
    takes it)."""
    bad = []
    if cout > 256:
        bad.append(f"Cout={cout} > 256 (K3 keeps a pixel's outputs in registers)")
    if cin % 4 or ce % 4 or cout % 4:
        bad.append(f"channel counts Cin={cin}, Ce={ce}, Cout={cout} are not multiples of 4")
    if _smem_bytes(stride, cin, cout) > _SMEM_LIMIT:
        bad.append(f"Cin={cin}, Cout={cout} at stride {stride} overflow a block's shared memory")
    return bad


def check_fused_infer(stage: str, cin: int, ce: int, cout: int, stride: int) -> None:
    """Refuses, by stage, a block that fused_inference's kernel cannot run."""
    bad = fused_infer_limits(cin, ce, cout, stride)
    if bad:
        raise ValueError(f"{stage}: CameraEncoderConfig(fused_inference=True) cannot run this "
                         f"block on the card: {'; '.join(bad)}; use fused_inference=False")


# K3's W1 and W2 fragments, built once per folded-parameter set: keyed by the
# weight tensor's identity (IRParams' tensors live as long as the module's
# cached folding; an entry goes when its tensor does), rebuilt when the
# tensor changes in place.
_INFER_FRAGMENTS: dict = {}


def _infer_fragments(w: torch.Tensor, dt: torch.dtype) -> Tuple[torch.Tensor, int]:
    """mma_fragments of w's dt values and its k-steps a n-tile, cached on w.
    Built on w's device by tensor ops: no host sync."""
    key = (id(w), dt)
    # A tensor made under torch.inference_mode (the Predictor folds its BN
    # there) has no version counter.
    version = None if w.is_inference() else w._version
    hit = _INFER_FRAGMENTS.get(key)
    if hit is None or hit[0]() is not w or hit[1] != version:
        if hit is None or hit[0]() is not w:
            weakref.finalize(w, _INFER_FRAGMENTS.pop, key, None)
        hit = (weakref.ref(w), version, *_fragments(_w(w, dt), dt))
        _INFER_FRAGMENTS[key] = hit
    return hit[2], hit[3]


def infer_plan(B: int, H: int, W: int, cin: int, ce: int, cout: int, stride: int,
               has_expand: bool, dtype: torch.dtype) -> dict:
    """K3's launch for these shapes on the current card (chip_smoke.py
    prints it): output tile, shared memory a block, resident blocks per SM,
    blocks launched."""
    o = (ctypes.c_int * 5)()
    err = KERNEL.lib().ir_fused_infer_plan(B, H, W, cin, ce, cout, stride, int(has_expand),
                                           0 if dtype == torch.float32 else 1,
                                           ctypes.addressof(o))
    if err:
        raise RuntimeError(f"ir_fused_infer_plan: CUDA error {err}")
    return {"tile": f"{o[0]}x{o[1]}", "smem_bytes": o[2], "blocks_per_sm": o[3],
            "blocks": o[4]}


def _fused_ir_infer_cuda(x, w1, s1, b1, dw, s2, b2, w2, s3, b3, stride: int) -> torch.Tensor:
    p = IRParams(w1, s1, b1, dw, s2, b2, w2, s3, b3)
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    B, H, W, Cin = x.shape
    Ce, Cout = p.dw.shape[-1], p.w2.shape[-1]
    has_expand = p.w1 is not None
    if not has_expand and Ce != Cin:
        raise ValueError("expansion-1 block must have Ce == Cin")
    bad = fused_infer_limits(Cin, Ce, Cout, stride)
    if bad:
        raise ValueError(f"fused_ir_infer kernel cannot take this block: {'; '.join(bad)}")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    dt = x.dtype
    x = aligned16(x.contiguous())
    # The kernel copies s1, b1, the taps, s2 and b2 in 16-byte pieces.
    f32 = [aligned16(t.float().contiguous()) for t in (p.s2, p.b2, p.s3, p.b3)]
    # Taps hold values of the input dtype, passed as f32; W1 and W2 as their
    # pre-split fragments.
    dw = aligned16(_w(p.dw, dt).reshape(9, Ce))
    w2f, ks2 = _infer_fragments(p.w2, dt)
    if has_expand:
        w1f, ks1 = _infer_fragments(p.w1, dt)
        s1, b1 = (aligned16(v) for v in _v(p.s1, p.b1))
        dev = check_cuda_args(x, w1f, s1, b1, dw, w2f, *f32)
    else:
        w1f, ks1, s1, b1 = None, 0, None, None
        dev = check_cuda_args(x, dw, w2f, *f32)
    out = torch.empty(B, Ho, Wo, Cout, dtype=dt, device=dev)
    residual = int(stride == 1 and Cin == Cout)
    KERNEL.launch("ir_fused_infer", ptr(x), ptr(w1f), ptr(s1), ptr(b1), ptr(dw),
                  ptr(f32[0]), ptr(f32[1]), ptr(w2f), ptr(f32[2]), ptr(f32[3]), ptr(out),
                  B, H, W, Ho, Wo, Cin, Ce, Cout, ks1, ks2, stride, int(has_expand), residual,
                  dtype_code(x), stream_ptr(dev))
    return out


def _fused_ir_infer_fake(x, w1, s1, b1, dw, s2, b2, w2, s3, b3, stride: int) -> torch.Tensor:
    B, H, W, _ = x.shape
    return x.new_empty(B, (H - 1) // stride + 1, (W - 1) // stride + 1, w2.shape[-1])


# K3 as the operator lmsu_tpu_torch::fused_ir_infer (ops/_cuda.py::define_op),
# over IRParams' fields (w1, s1 and b1 absent at expansion 1).
_FUSED_IR_INFER = define_op(
    "fused_ir_infer", "(Tensor x, Tensor? w1, Tensor? s1, Tensor? b1, Tensor dw, Tensor s2, "
    "Tensor b2, Tensor w2, Tensor s3, Tensor b3, int stride) -> Tensor",
    lambda x, w1, s1, b1, dw, s2, b2, w2, s3, b3, stride: fused_ir_infer_plain(
        x, IRParams(w1, s1, b1, dw, s2, b2, w2, s3, b3), stride),
    _fused_ir_infer_cuda, _fused_ir_infer_fake)


def fused_ir_infer(x: torch.Tensor, p: IRParams, stride: int = 1) -> torch.Tensor:
    """Fused eval InvertedResidual on NHWC x [B, H, W, Cin] (f32 or bf16):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    check_device("fused_ir_infer", x)
    return _FUSED_IR_INFER(x, *p, stride)


# -- training: kernels K8-K13 and their plain versions ------------------------

_REDUCE_ROWS = 256     # rows per group in the kernels' fixed-order partial sums
_STRIP_ROWS = 1024     # pixels per block span of K13 (a multiple of 64)

STATS1 = CudaKernel("ir_train_stats1.cu", {
    "ir_train_stats1": (_P,) * 8 + (_L,) + (_I,) * 6 + (_P,),
    "ir_train_stats1_tile": (_I,) * 3,
    "ir_train_stats1_rows": (_L,) + (_I,) * 3,
    "ir_train_stats1_smem": (_I,) * 3,
    "ir_train_stats1_occupancy": (_I,) * 3})
EXPAND_DW = CudaKernel("ir_train_expand_dw.cu", {
    "ir_train_expand_dw": (_P,) * 12 + (_I,) * 10 + (_P,),
    "ir_train_expand_dw_smem": (_I,) * 4,
    "ir_train_expand_dw_occupancy": (_I,) * 4,
    "ir_train_expand_dw_rows": (_I,) * 8})
PROJ = CudaKernel("ir_train_proj.cu", {
    "ir_train_proj": (_P,) * 5 + (_L,) + (_I,) * 5 + (_P,),
    "ir_train_proj_smem": (_I,) * 3,
    "ir_train_proj_occupancy": (_I,) * 3})
PROJ_BWD = CudaKernel("ir_train_proj_bwd.cu", {
    "ir_train_proj_bwd": (_P,) * 15 + (_L,) + (_I,) * 6 + (_P,),
    "ir_train_proj_bwd_rows": (_L,) + (_I,) * 3,
    "ir_train_proj_bwd_groups": (_I,) * 3,
    "ir_train_proj_bwd_chunks": (_I,) * 3,
    "ir_train_proj_bwd_smem": (_I,) * 3,
    "ir_train_proj_bwd_occupancy": (_I,) * 3})
DW_BWD = CudaKernel("ir_train_dw_bwd.cu", {
    "ir_train_dw_bwd": (_P,) * 23 + (_I,) * 12 + (_P,),
    "ir_train_dw_bwd_smem": (_I,) * 4,
    "ir_train_dw_bwd_occupancy": (_I,) * 4,
    "ir_train_dw_bwd_rows": (_I,) * 8})
EXPAND_BWD = CudaKernel("ir_train_expand_bwd.cu", {
    "ir_train_expand_bwd": (_P,) * 14 + (_L,) + (_I,) * 7 + (_P,),
    "ir_train_expand_bwd_groups": (_I,) * 3,
    "ir_train_expand_bwd_smem": (_I,) * 3})

_F32 = torch.float32


def _rnd(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """v rounded to dt, as f32 (the TPU kernels' `.astype(x.dtype)`)."""
    return v.to(dt).float()


def _mask(v: torch.Tensor) -> torch.Tensor:
    """The fused path's ReLU6 derivative: 1 strictly inside (0, 6), else 0."""
    return ((v > 0.0) & (v < 6.0)).float()


def _check_spatial(H: int, W: int, stride: int) -> None:
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if stride == 2 and (H % 2 or W % 2):
        raise ValueError(
            f"fused InvertedResidual needs even spatial dims at stride-2 stages, got "
            f"{H}x{W}; use the unfused path (CameraEncoderConfig.fused_train=False) for "
            f"image sizes not divisible by 16.")


def _on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for CUDA."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, not {t.device}")
    return True


def _check_shapes(name: str, **tensors) -> None:
    """Each keyword is (tensor, expected shape): a kernel reads by these
    shapes, so a mismatch raises before any pointer is passed."""
    for label, (t, shape) in tensors.items():
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} must be {tuple(shape)}, got {tuple(t.shape)}")


def _w(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A weight as the kernels take it: f32 holding input-dtype values."""
    return t.detach().to(dt).float().contiguous()


def _v(*ts) -> list:
    """Per-channel vectors as the kernels take them: contiguous f32."""
    return [t.detach().float().contiguous() for t in ts]


def _scratch(dev, *reductions) -> Optional[torch.Tensor]:
    """The second-level buffer of the kernels' partial sums: for each
    reduction (rows, columns) with more rows than one group, ceil(rows /
    _REDUCE_ROWS) rows of its width; None when no reduction needs one."""
    n = max([-(-rows // _REDUCE_ROWS) * cols for rows, cols in reductions
             if rows > _REDUCE_ROWS], default=0)
    return torch.empty(n, dtype=_F32, device=dev) if n else None


def _expand_act(x, w1, s1, b1):
    """e (rounded), v1 = e * s1 + b1 and e_act (rounded) of the expand 1x1."""
    dt = x.dtype
    e = _rnd(x.float() @ _rnd(w1, dt), dt)
    v1 = e * s1.float() + b1.float()
    return e, v1, _rnd(_relu6(v1), dt)


def _dw_taps(dw, dt):
    """[3, 3, Ce] taps rounded to dt -> the [Ce, 1, 3, 3] grouped-conv weight."""
    return _rnd(dw, dt).permute(2, 0, 1).unsqueeze(1)


# The shared expand of K8, K9, K12 and K13 (csrc/ir_train_common.cuh::expand_step)
# ---------------------------------------------------------------------------

# bf16 terms of each f32 operand: products x_i . W_j with i + j < EXPAND_TERMS
# (six for f32, one exact product for bf16). Chosen with `expand_e_emulated`
# at the student's widths (tests/test_torch_ir_expand_split.py): two terms
# leave e more than 1e-6 of its scale from the float64 product, three well
# inside it.
EXPAND_TERMS = 3
_FRAG_PAD = 64  # fragment arrays pad K and N to multiples of this


def mma_products(dtype: torch.dtype) -> int:
    """bf16 tensor-core products the kernels issue per f32-level product:
    f32 operands are split into EXPAND_TERMS terms, bf16 ones are exact."""
    terms = 1 if dtype == torch.bfloat16 else EXPAND_TERMS
    return sum(1 for i in range(terms) for j in range(terms) if i + j < terms)


def _terms(v: torch.Tensor, dt: torch.dtype, terms: int = EXPAND_TERMS) -> list:
    """v (holding dt values) as the kernels' bf16 terms, as f32 tensors."""
    return [v.float()] if dt == torch.bfloat16 else split_bf16(v.float(), terms)


def mma_fragments(b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A [K, N] B operand (values of dt) -> the kernels' pre-split fragment
    array [Np/8, Kp/16, terms, 32, 4] bf16 (Kp, Np: K, N padded with zeros
    to multiples of 64; terms 3 for f32, 1 for bf16): for n-tile j, k-step s
    and term i, lane 4 g + t holds b_i[16 s + 2 t + (0, 1, 8, 9)][8 j + g],
    the B fragment of mma.m16n8k16 (ir_train_common.cuh::load_b)."""
    k, n = b.shape
    kp, np_ = -(-k // _FRAG_PAD) * _FRAG_PAD, -(-n // _FRAG_PAD) * _FRAG_PAD
    t = torch.stack([F.pad(v, (0, np_ - n, 0, kp - k)) for v in _terms(b, dt)])
    t = t.reshape(t.shape[0], kp // 16, 2, 4, 2, np_ // 8, 8)     # i, s, h, t, e, j, g
    return t.permute(5, 1, 0, 6, 3, 2, 4).reshape(np_ // 8, kp // 16, -1, 32, 4) \
        .to(torch.bfloat16).contiguous()


def _fragments(w: torch.Tensor, dt: torch.dtype) -> Tuple[torch.Tensor, int]:
    """mma_fragments(w) and its k-steps per n-tile."""
    f = mma_fragments(w, dt)
    return f, f.shape[1]


def mma_matmul_emulated(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype,
                        terms: int = EXPAND_TERMS, k_split: Optional[int] = None
                        ) -> torch.Tensor:
    """a [M, K] @ b [K, N] (both holding dt values) as the kernels' mma_step
    forms it, in plain PyTorch (tests only; the main path never calls it):
    f32 operands split into `terms` bf16 terms, per 16-deep k-step the
    products a_i b_j (i + j < terms) summed smallest first into a fresh f32
    sum, and each k-step's sum added to the running total in f32. With
    `k_split`, K is cut into spans of that many (a multiple of 16) summed
    apart, and the spans' sums added in order (K11's dW2 partials)."""
    depth = a.shape[1]
    if k_split is not None and k_split < depth:
        parts = [mma_matmul_emulated(a[:, k0:k0 + k_split], b[k0:k0 + k_split], dt, terms)
                 for k0 in range(0, depth, k_split)]
        return torch.stack(parts).sum(0)
    xs, ws = _terms(a, dt, terms), _terms(b, dt, terms)
    pairs = [(i, s - i) for s in range(terms - 1, -1, -1) for i in range(terms - 1, -1, -1)
             if 0 <= s - i < len(ws) and i < len(xs)]
    acc = None
    for k0 in range(0, depth, 16):
        tmp = None
        for i, j in pairs:
            prod = xs[i][:, k0:k0 + 16] @ ws[j][k0:k0 + 16]
            tmp = prod if tmp is None else tmp + prod
        acc = tmp if acc is None else acc + tmp
    return acc


def expand_e_emulated(x: torch.Tensor, w1: torch.Tensor,
                      terms: int = EXPAND_TERMS) -> torch.Tensor:
    """The shared expand's arithmetic (mma_matmul_emulated): e = x @ W1
    rounded to x's dtype, as f32."""
    dt = x.dtype
    acc = mma_matmul_emulated(x.reshape(-1, x.shape[-1]).float(), _rnd(w1, dt), dt, terms)
    return _rnd(acc, dt).reshape(*x.shape[:-1], -1)


def fused_ir_infer_emulated(x: torch.Tensor, p: IRParams, stride: int,
                            terms: int = EXPAND_TERMS) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch (the tests, and chip_smoke.py on
    infer_rounding_probe; the main path never calls it): fused_ir_infer_plain
    with both 1x1 products formed as mma_step forms them
    (mma_matmul_emulated) and K3's rounding points, which are the TPU
    inference kernel's: e is NOT rounded before BN1 (relu6(e * s1 + b1) is),
    d is, the BN3 result is, and the residual is added in the input dtype."""
    dt = x.dtype
    B, H, W, cin = x.shape
    cout = p.w2.shape[-1]
    if p.w1 is not None:
        e = mma_matmul_emulated(x.reshape(-1, cin).float(), _rnd(p.w1, dt), dt, terms)
        e_act = _rnd(_relu6(e * p.s1.float() + p.b1.float()), dt).reshape(B, H, W, -1)
    else:
        e_act = x.float()
    ce = e_act.shape[-1]
    d = F.conv2d(e_act.permute(0, 3, 1, 2), _dw_taps(p.dw, dt), stride=stride, padding=1,
                 groups=ce).permute(0, 2, 3, 1)
    d = _rnd(_relu6(d * p.s2.float() + p.b2.float()), dt)
    y = mma_matmul_emulated(d.reshape(-1, ce), _rnd(p.w2, dt), dt, terms)
    out = (y * p.s3.float() + p.b3.float()).reshape(*d.shape[:-1], cout).to(dt)
    if stride == 1 and cin == cout:
        out = x + out
    return out


def infer_rounding_probe() -> Tuple[torch.Tensor, IRParams]:
    """A block on which K3's rounding points show, as f32 CPU tensors: x
    [1, 4, 4, 4] and folded parameters whose channel 0 of e = x @ W1 is
    exactly 1 + 3 * 2^-10 at every pixel (W1's column 0 = (1, 1, 0, 0)).
    With s1 = 3, e * s1 = 3 + 9 * 2^-10 rounds to 3 + 2^-6 in bf16, while
    rounding e first (the training path's point) gives 1 * 3 = 3. The
    depthwise is the identity (centre tap 1), BN2 and BN3 are the identity
    and W2 copies channel 0 to output 0 of 8 (no residual)."""
    x = torch.zeros(1, 4, 4, 4)
    x[..., 0], x[..., 1] = 1.0, 3 * 2.0 ** -10
    w1 = torch.zeros(4, 4)
    w1[0, 0] = w1[1, 0] = 1.0
    dw = torch.zeros(3, 3, 4)
    dw[1, 1] = 1.0
    w2 = torch.zeros(4, 8)
    w2[0, 0] = 1.0
    return x, IRParams(w1, torch.full((4,), 3.0), torch.zeros(4), dw, torch.ones(4),
                       torch.zeros(4), w2, torch.ones(8), torch.zeros(8))


# Shape limits of K8, K9, K12 and K13 on the card (the JAX package's kernels
# have none): refused by name when a model is built, not mid-step.

def _k13_smem(cin: int, cg: int, nbuf: int, es: int) -> int:
    """csrc/ir_train_expand_bwd.cu::smem_of."""
    k16 = -(-cin // 16) * 16
    ldt = -(-k16 // 64) * 64
    nt = 3 if es == 4 else 1
    x = nbuf * 64 * k16 * 4 + nt * 64 * ldt * 2 if es == 4 else nbuf * 64 * ldt * 2
    return x + nt * 64 * 64 * 2 + cin * cg * 4 + 5 * cg * 4


def _k8_smem(cin: int, ce: int, es: int) -> int:
    """csrc/ir_train_stats1.cu::smem_of for its smaller tile: 64 pixels of x
    (Cin padded to 16, rows to 128 bytes), the two-slot ring of W1's
    fragments for 16 n-tiles and the two pixel warps' [2][Ce] sums."""
    per = 128 // es
    ldx = -(-(-(-cin // 16) * 16) // per) * per
    return 64 * ldx * es + 2 * 16 * (2 * 3 * 256 if es == 4 else 4 * 256) + 16 * ce


def _k12_smem(cin: int, stride: int, es: int) -> int:
    """csrc/ir_train_dw_bwd.cu::Layout::bytes with an expand: stride 1
    stages the whole halo (100 pixels, Cin padded to 128 bytes), stride 2 a
    ring of 16-channel chunks."""
    if stride == 2:
        return 114688 if es == 4 else 64896
    per = 128 // es
    ldx = -(-(-(-cin // 16) * 16) // per) * per
    return 100 * ldx * es + (53504 if es == 4 else 34304)


def fused_train_limits(cin: int, ce: int, has_expand: bool, stride: int = 1) -> list:
    """What K8, K9, K12 or K13 cannot take for a block with these widths
    (empty when the kernels take it)."""
    bad = []
    if cin % 8:
        bad.append(f"Cin={cin} is not a multiple of 8 (K8, K9, K12, K13 copy x in 16-byte rows)")
    if ce % 32:
        bad.append(f"Ce={ce} is not a multiple of 32 (K12 walks 32-channel items)")
    if has_expand and _k12_smem(cin, stride, 4) > _SMEM_LIMIT:
        bad.append(f"Cin={cin} at stride 1 overflows K12's shared memory with the halo")
    if has_expand and _k13_smem(cin, 64, 0, 4) > _SMEM_LIMIT:
        bad.append(f"Cin={cin} leaves K13 no 64-channel group in a block's shared memory")
    if has_expand and _k8_smem(cin, ce, 4) > _SMEM_LIMIT:
        bad.append(f"Cin={cin}, Ce={ce} overflow K8's shared memory with a 64-pixel tile")
    return bad


def check_fused_train(stage: str, cin: int, ce: int, has_expand: bool, stride: int = 1) -> None:
    """Refuses, by stage, a block that fused_train's kernels cannot run."""
    bad = fused_train_limits(cin, ce, has_expand, stride)
    if bad:
        raise ValueError(f"{stage}: CameraEncoderConfig(fused_train=True) cannot run this block "
                         f"on the card: {'; '.join(bad)}; use fused_train=False")


# K8 ----------------------------------------------------------------------


def stats1_plain(x, w1):
    """x [B, H, W, Cin], W1 [Cin, Ce] -> (sum e, sum e^2) [Ce] f32 of
    e = x @ W1 rounded to x's dtype."""
    e = _rnd(x.reshape(-1, x.shape[-1]).float() @ _rnd(w1, x.dtype), x.dtype)
    return e.sum(0), (e * e).sum(0)


def stats1(x, w1, *, probe: Optional[torch.Tensor] = None):
    """K8 (`_stats1_kernel`): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `probe` (CUDA): an f32 [B, H, W, Ce] tensor
    that the kernel also fills with its e, rounded to x's dtype
    (chip_smoke.py compares it with K9's)."""
    cin, ce = x.shape[-1], w1.shape[-1]
    _check_shapes("stats1", w1=(w1, (cin, ce)), probe=(probe, (*x.shape[:-1], ce)))
    if not _on_card("stats1", x):
        return stats1_plain(x, w1)
    if cin % 8 or _k8_smem(cin, ce, x.element_size()) > _SMEM_LIMIT:
        raise ValueError(f"stats1 kernel cannot take Cin={cin}, Ce={ce}: Cin % 8 == 0 and a "
                         f"64-pixel tile in shared memory")
    x = aligned16(x.contiguous())
    M = x.numel() // cin
    wf, ks = _fragments(_w(w1, x.dtype), x.dtype)
    dev = check_cuda_args(x, wf)
    rows = STATS1.lib().ir_train_stats1_rows(M, cin, ce, dtype_code(x))
    part = torch.empty(2, rows, ce, dtype=_F32, device=dev)
    scratch = _scratch(dev, (rows, ce))
    out = torch.empty(2, ce, dtype=_F32, device=dev)
    STATS1.launch("ir_train_stats1", ptr(x), ptr(wf), ptr(part[0]), ptr(part[1]), ptr(scratch),
                  ptr(out[0]), ptr(out[1]), ptr(probe), M, cin, ce, ks, wf.shape[0],
                  _REDUCE_ROWS, dtype_code(x), stream_ptr(dev))
    return out[0], out[1]


# K9 ----------------------------------------------------------------------


def expand_dw_plain(x, w1, s1, b1, dw, stride):
    """x [B, H, W, Cin] -> (d [B, Ho, Wo, Ce] in x's dtype, sum d, sum d^2):
    e_act = relu6(e * s1 + b1) (x itself when w1 is None), d = the depthwise
    3x3 of e_act, padding 1, rounded to x's dtype; the sums over that d."""
    dt = x.dtype
    e_act = _expand_act(x, w1, s1, b1)[2] if w1 is not None else x.float()
    ce = e_act.shape[-1]
    d = F.conv2d(e_act.permute(0, 3, 1, 2), _dw_taps(dw, dt), stride=stride, padding=1,
                 groups=ce).permute(0, 2, 3, 1).to(dt).contiguous()
    d32 = d.float()
    return d, d32.sum((0, 1, 2)), (d32 * d32).sum((0, 1, 2))


def expand_dw(x, w1, s1, b1, dw, stride, *, probe: Optional[torch.Tensor] = None):
    """K9 (`_expand_dw_kernel`); w1, s1, b1 None at expansion 1. `probe`
    (CUDA, with w1): an f32 [B, H, W, Ce] tensor that the kernel also fills
    with e, rounded to x's dtype (chip_smoke.py compares it with K12's)."""
    B, H, W, cin = x.shape
    _check_spatial(H, W, stride)
    ce = dw.shape[-1]
    _check_shapes("expand_dw", w1=(w1, (cin, ce)), s1=(s1, (ce,)), b1=(b1, (ce,)),
                  dw=(dw, (3, 3, ce)), probe=(probe, (B, H, W, ce)))
    if not _on_card("expand_dw", x):
        return expand_dw_plain(x, w1, s1, b1, dw, stride)
    has_expand = w1 is not None
    if cin % 8 or (not has_expand and ce != cin):
        raise ValueError(f"expand_dw kernel takes Cin % 8 == 0 (and Ce == Cin at "
                         f"expansion 1), got Cin={cin}, Ce={ce}")
    dt = x.dtype
    x = aligned16(x.contiguous())
    Ho, Wo = H // stride, W // stride
    taps = _w(dw, dt).reshape(9, ce)
    if has_expand:
        (wf, ks), (sv, bv) = _fragments(_w(w1, dt), dt), _v(s1, b1)
        dev = check_cuda_args(x, wf, sv, bv, taps)
    else:
        wf, ks, sv, bv = None, 0, None, None
        dev = check_cuda_args(x, taps)
    rows = EXPAND_DW.lib().ir_train_expand_dw_rows(B, H, W, cin, ce, stride, int(has_expand),
                                                   dtype_code(x))
    if rows <= 0:
        raise RuntimeError(f"ir_train_expand_dw_rows: CUDA error {-rows}")
    part = torch.empty(2, rows, ce, dtype=_F32, device=dev)
    out = torch.empty(2, ce, dtype=_F32, device=dev)
    d = torch.empty(B, Ho, Wo, ce, dtype=dt, device=dev)
    EXPAND_DW.launch("ir_train_expand_dw", ptr(x), ptr(wf), ptr(sv), ptr(bv), ptr(taps), ptr(d),
                     ptr(part[0]), ptr(part[1]), ptr(_scratch(dev, (rows, ce))), ptr(out[0]),
                     ptr(out[1]), ptr(probe), B, H, W, cin, ce, ks, stride, int(has_expand),
                     _REDUCE_ROWS, dtype_code(x), stream_ptr(dev))
    return d, out[0], out[1]


# K10 ---------------------------------------------------------------------


def proj_plain(d, s2, b2, w2):
    """d [B, Ho, Wo, Ce] -> y = relu6(d * s2 + b2) (rounded) @ W2, f32."""
    d_act = _rnd(_relu6(d.float() * s2.float() + b2.float()), d.dtype)
    return d_act @ _rnd(w2, d.dtype)


def proj(d, s2, b2, w2):
    """K10 (`_proj_kernel`): y [B, Ho, Wo, Cout] f32."""
    ce, cout = d.shape[-1], w2.shape[-1]
    _check_shapes("proj", s2=(s2, (ce,)), b2=(b2, (ce,)), w2=(w2, (ce, cout)))
    if not _on_card("proj", d):
        return proj_plain(d, s2, b2, w2)
    d = aligned16(d.contiguous())
    M = d.numel() // ce
    wf, ks = _fragments(_w(w2, d.dtype), d.dtype)
    sv, bv = _v(s2, b2)
    dev = check_cuda_args(d, sv, bv, wf)
    y = torch.empty(*d.shape[:-1], cout, dtype=_F32, device=dev)
    PROJ.launch("ir_train_proj", ptr(d), ptr(sv), ptr(bv), ptr(wf), ptr(y), M, ce, cout, ks,
                wf.shape[0], dtype_code(d), stream_ptr(dev))
    return y


def proj_emulated(d, s2, b2, w2, terms: int = EXPAND_TERMS):
    """K10's arithmetic in plain PyTorch (tests only): proj_plain with the
    product formed as the kernel forms it (mma_matmul_emulated)."""
    ce = d.shape[-1]
    d_act = _rnd(_relu6(d.float() * s2.float() + b2.float()), d.dtype).reshape(-1, ce)
    y = mma_matmul_emulated(d_act, _rnd(w2, d.dtype), d.dtype, terms)
    return y.reshape(*d.shape[:-1], -1)


# K11 ---------------------------------------------------------------------


def proj_bwd_plain(d, dy, s2, b2, m2, inv2, w2):
    """-> (dv2 in d's dtype, dW2 [Ce, Cout] f32, sum dv2, sum dv2 * dn):
    dW2 = d_act^T dy, dv2 = relu6'(v2) (dy W2^T), dn = (d - m2) inv2."""
    dt = d.dtype
    ce, cout = d.shape[-1], dy.shape[-1]
    d32 = d.reshape(-1, ce).float()
    dy32 = dy.reshape(-1, cout).float()
    v2 = d32 * s2.float() + b2.float()
    dw2 = _rnd(_relu6(v2), dt).T @ dy32
    dv2 = (dy32 @ _rnd(w2, dt).T) * _mask(v2)
    dn = (d32 - m2.float()) * inv2.float()
    return dv2.to(dt).reshape(d.shape), dw2, dv2.sum(0), (dv2 * dn).sum(0)


def proj_bwd_emulated(d, dy, s2, b2, m2, inv2, w2, span: int, terms: int = EXPAND_TERMS):
    """K11's arithmetic in plain PyTorch (tests only): proj_bwd_plain with
    dd_hat = dy W2^T and dW2 = d_act^T dy formed as the kernel forms them
    (mma_matmul_emulated; dW2 summed over spans of `span` pixels, then the
    spans' partials added). The mask is the plain version's own expression,
    v2 = d * s2 + b2 elementwise, as in the kernel."""
    dt = d.dtype
    ce, cout = d.shape[-1], dy.shape[-1]
    d32 = d.reshape(-1, ce).float()
    dy32 = dy.reshape(-1, cout).float()
    v2 = d32 * s2.float() + b2.float()
    d_act = _rnd(_relu6(v2), dt)
    dw2 = mma_matmul_emulated(d_act.T.contiguous(), dy32, dt, terms, k_split=span)
    dv2 = mma_matmul_emulated(dy32, _rnd(w2, dt).T.contiguous(), dt, terms) * _mask(v2)
    dn = (d32 - m2.float()) * inv2.float()
    return dv2.to(dt).reshape(d.shape), dw2, dv2.sum(0), (dv2 * dn).sum(0)


def proj_bwd(d, dy, s2, b2, m2, inv2, w2):
    """K11 (`_proj_bwd_kernel`)."""
    ce, cout = d.shape[-1], w2.shape[-1]
    _check_shapes("proj_bwd", dy=(dy, (*d.shape[:-1], cout)), w2=(w2, (ce, cout)),
                  **{k: (v, (ce,)) for k, v in (("s2", s2), ("b2", b2), ("m2", m2),
                                                ("inv2", inv2))})
    if not _on_card("proj_bwd", d):
        return proj_bwd_plain(d, dy, s2, b2, m2, inv2, w2)
    if dy.dtype != d.dtype:
        raise ValueError(f"d and dy must share a dtype, got {d.dtype} and {dy.dtype}")
    d, dy = aligned16(d.contiguous()), aligned16(dy.contiguous())
    M = d.numel() // ce
    wtf, kst = _fragments(_w(w2, d.dtype).T, d.dtype)
    vs = _v(s2, b2, m2, inv2)
    dev = check_cuda_args(d, dy, wtf, *vs)
    rows = PROJ_BWD.lib().ir_train_proj_bwd_rows(M, ce, cout, dtype_code(d))
    part = torch.empty(2, rows, ce, dtype=_F32, device=dev)
    part_w = torch.empty(rows, ce * cout, dtype=_F32, device=dev)
    scratch = _scratch(dev, (rows, ce), (rows, ce * cout))
    dv2 = torch.empty_like(d)
    dw2 = torch.empty(ce, cout, dtype=_F32, device=dev)
    r = torch.empty(2, ce, dtype=_F32, device=dev)
    PROJ_BWD.launch("ir_train_proj_bwd", ptr(d), ptr(dy), *(ptr(v) for v in vs), ptr(wtf),
                    ptr(dv2), ptr(part[0]), ptr(part[1]), ptr(part_w), ptr(scratch), ptr(dw2),
                    ptr(r[0]), ptr(r[1]), M, ce, cout, kst, wtf.shape[0], _REDUCE_ROWS,
                    dtype_code(d), stream_ptr(dev))
    return dv2, dw2, r[0], r[1]


# K12 ---------------------------------------------------------------------


def dw_bwd_plain(x, w1, s1, b1, m1, inv1, dw, dv2, u2, p2, q2, d, m2, inv2, stride):
    """-> (dv1 [B, H, W, Ce] in x's dtype, dDW [9, Ce] f32, sum dv1, sum
    dv1 * en): dd = u2 dv2 - p2 - q2 (d - m2) inv2 (rounded), dDW[t] the
    tap sums of e_act against dd, de_act the transposed depthwise conv of
    dd, dv1 = relu6'(v1) de_act, en = (e - m1) inv1. At expansion 1 (w1
    None): dv1 = de_act and the sums are 0."""
    dt = x.dtype
    dn = (d.float() - m2.float()) * inv2.float()
    dd = _rnd(u2.float() * dv2.float() - p2.float() - q2.float() * dn, dt)
    if w1 is not None:
        e, v1, e_act = _expand_act(x, w1, s1, b1)
    else:
        e_act = x.float()
    Ho, Wo, ce = dd.shape[1:]
    ep = F.pad(e_act, (0, 0, 1, 1, 1, 1))
    ddw = torch.stack([
        (ep[:, ky:ky + stride * (Ho - 1) + 1:stride, kx:kx + stride * (Wo - 1) + 1:stride]
         * dd).sum((0, 1, 2)) for ky in range(3) for kx in range(3)])
    de_act = F.conv_transpose2d(dd.permute(0, 3, 1, 2), _dw_taps(dw, dt), stride=stride,
                                padding=1, output_padding=stride - 1,
                                groups=ce).permute(0, 2, 3, 1)
    if w1 is not None:
        dv1 = de_act * _mask(v1)
        en = (e - m1.float()) * inv1.float()
        ra, rb = dv1.sum((0, 1, 2)), (dv1 * en).sum((0, 1, 2))
    else:
        dv1 = de_act
        ra = rb = torch.zeros(ce, dtype=_F32, device=x.device)
    return dv1.to(dt).contiguous(), ddw, ra, rb


def dw_bwd(x, w1, s1, b1, m1, inv1, dw, dv2, u2, p2, q2, d, m2, inv2, stride, *,
           probe: Optional[torch.Tensor] = None):
    """K12 (`_dw_bwd_kernel`); w1, s1, b1, m1, inv1 None at expansion 1.
    `probe` as for expand_dw: the kernel also writes its e there."""
    B, H, W, cin = x.shape
    _check_spatial(H, W, stride)
    ce = dw.shape[-1]
    om = (B, H // stride, W // stride, ce)
    _check_shapes("dw_bwd", w1=(w1, (cin, ce)), dw=(dw, (3, 3, ce)), dv2=(dv2, om), d=(d, om),
                  probe=(probe, (B, H, W, ce)),
                  **{k: (v, (ce,)) for k, v in (("s1", s1), ("b1", b1), ("m1", m1),
                                                ("inv1", inv1), ("u2", u2), ("p2", p2),
                                                ("q2", q2), ("m2", m2), ("inv2", inv2))})
    if not _on_card("dw_bwd", x):
        return dw_bwd_plain(x, w1, s1, b1, m1, inv1, dw, dv2, u2, p2, q2, d, m2, inv2, stride)
    has_expand = w1 is not None
    if cin % 8 or ce % 32 or (not has_expand and ce != cin):
        raise ValueError(f"dw_bwd kernel takes Cin % 8 == 0, Ce % 32 == 0 (and Ce == Cin at "
                         f"expansion 1), got Cin={cin}, Ce={ce}")
    if not (x.dtype == dv2.dtype == d.dtype):
        raise ValueError("x, dv2 and d must share a dtype")
    lib = DW_BWD.lib()
    dt = x.dtype
    x, dv2, d = (aligned16(t.contiguous()) for t in (x, dv2, d))
    Ho, Wo = H // stride, W // stride
    taps = _w(dw, dt).reshape(9, ce)
    u2, p2, q2, m2, inv2 = _v(u2, p2, q2, m2, inv2)
    if has_expand:
        w, ks = _fragments(_w(w1, dt), dt)
        s1, b1, m1, inv1 = _v(s1, b1, m1, inv1)
        dev = check_cuda_args(x, w, s1, b1, m1, inv1, taps, dv2, u2, p2, q2, d, m2, inv2)
    else:
        w = s1 = b1 = m1 = inv1 = None
        ks = 0
        dev = check_cuda_args(x, taps, dv2, u2, p2, q2, d, m2, inv2)
    rows = lib.ir_train_dw_bwd_rows(B, Ho, Wo, cin, ce, stride, int(has_expand), dtype_code(x))
    if rows <= 0:
        raise RuntimeError(f"ir_train_dw_bwd_rows: CUDA error {-rows}")
    part_dw = torch.empty(rows, 9 * ce, dtype=_F32, device=dev)
    part = torch.empty(2, rows, ce, dtype=_F32, device=dev)
    dv1 = torch.empty(B, H, W, ce, dtype=dt, device=dev)
    ddw = torch.empty(9, ce, dtype=_F32, device=dev)
    r = torch.empty(2, ce, dtype=_F32, device=dev)
    DW_BWD.launch("ir_train_dw_bwd", ptr(x), ptr(w), ptr(s1), ptr(b1), ptr(m1), ptr(inv1),
                  ptr(taps), ptr(dv2), ptr(u2), ptr(p2), ptr(q2), ptr(d), ptr(m2), ptr(inv2),
                  ptr(dv1), ptr(part_dw), ptr(part[0]), ptr(part[1]),
                  ptr(_scratch(dev, (rows, 9 * ce))), ptr(ddw), ptr(r[0]), ptr(r[1]),
                  ptr(probe), B, H, W, Ho, Wo, cin, ce, ks, stride, int(has_expand),
                  _REDUCE_ROWS, dtype_code(x), stream_ptr(dev))
    return dv1, ddw, r[0], r[1]


# K13 ---------------------------------------------------------------------


def expand_bwd_plain(x, w1, m1, inv1, u1, p1, q1, dv1):
    """-> (dx [B, H, W, Cin] f32, dW1 [Cin, Ce] f32): e = x @ W1 (rounded),
    de = u1 dv1 - p1 - q1 (e - m1) inv1 (rounded), dW1 = x^T de,
    dx = de W1^T."""
    dt = x.dtype
    cin, ce = x.shape[-1], dv1.shape[-1]
    xm = x.reshape(-1, cin).float()
    w = _rnd(w1, dt)
    e = _rnd(xm @ w, dt)
    en = (e - m1.float()) * inv1.float()
    de = _rnd(u1.float() * dv1.reshape(-1, ce).float() - p1.float() - q1.float() * en, dt)
    return (de @ w.T).reshape(x.shape), xm.T @ de


def expand_bwd(x, w1, m1, inv1, u1, p1, q1, dv1):
    """K13 (`_expand_bwd_kernel`)."""
    cin, ce = x.shape[-1], dv1.shape[-1]
    _check_shapes("expand_bwd", dv1=(dv1, (*x.shape[:-1], ce)), w1=(w1, (cin, ce)),
                  **{k: (v, (ce,)) for k, v in (("m1", m1), ("inv1", inv1), ("u1", u1),
                                                ("p1", p1), ("q1", q1))})
    if not _on_card("expand_bwd", x):
        return expand_bwd_plain(x, w1, m1, inv1, u1, p1, q1, dv1)
    if cin % 8 or ce % 8 or dv1.dtype != x.dtype:
        raise ValueError(f"expand_bwd kernel takes Cin % 8 == 0, Ce % 8 == 0 and x, dv1 of one "
                         f"dtype, got Cin={cin}, Ce={ce}, {x.dtype} and {dv1.dtype}")
    dt = x.dtype
    x, dv1 = aligned16(x.contiguous()), aligned16(dv1.contiguous())
    M = x.numel() // cin
    w = _w(w1, dt)
    (wf, ks), (wtf, kst) = _fragments(w, dt), _fragments(w.T, dt)
    vs = _v(m1, inv1, u1, p1, q1)
    dev = check_cuda_args(x, wf, wtf, *vs, dv1)
    ngroups = EXPAND_BWD.lib().ir_train_expand_bwd_groups(cin, ce, dtype_code(x))
    if ngroups <= 0:
        raise ValueError(f"expand_bwd kernel: Cin={cin} leaves no 64-channel group in a "
                         f"block's shared memory")
    nstrip = -(-M // _STRIP_ROWS)
    dxp = torch.empty(ngroups, M, cin, dtype=_F32, device=dev) if ngroups > 1 else None
    dw1p = torch.empty(nstrip, cin * ce, dtype=_F32, device=dev)
    scratch = _scratch(dev, (ngroups, M * cin), (nstrip, cin * ce))
    dx = torch.empty(x.shape, dtype=_F32, device=dev)
    dw1 = torch.empty(cin, ce, dtype=_F32, device=dev)
    EXPAND_BWD.launch("ir_train_expand_bwd", ptr(x), ptr(wf), ptr(wtf), *(ptr(v) for v in vs),
                      ptr(dv1), ptr(dxp), ptr(dw1p), ptr(scratch), ptr(dx), ptr(dw1), M, cin,
                      ce, ks, kst, _STRIP_ROWS, _REDUCE_ROWS, dtype_code(x), stream_ptr(dev))
    return dx, dw1


# The block -----------------------------------------------------------------


def _bn_stats_finalize(s, sq, count):
    """flax _compute_stats (use_fast_variance): biased var = E[x^2] - E[x]^2."""
    mean = s / count
    return mean, sq / count - mean * mean


def _global(*vecs, count=None):
    """Sums of the global batch under data parallelism (parallel/mesh.py):
    the [C] vectors (and the row count, when given) all-reduced as one
    tensor. At world size 1 they come back as they are, with no collective.
    Returns (*vecs, count)."""
    if data_mesh() is None:
        return (*vecs, count)
    parts = [v.float().reshape(-1) for v in vecs]
    if count is not None:
        parts.append(torch.full((1,), float(count), dtype=_F32, device=vecs[0].device))
    flat = all_reduce_(torch.cat(parts))
    out = list(flat[:-1].split([v.numel() for v in vecs])) if count is not None \
        else list(flat.split([v.numel() for v in vecs]))
    return (*out, flat[-1] if count is not None else None)


class _FusedIRTrain(torch.autograd.Function):
    """ir_fused.py::fused_ir_train's custom VJP: _ir_train_forward (:566-666)
    and _ir_train_backward (:669-835) with K8-K13 for the kernels.

    Under data parallelism the three BN layers' statistics and their
    backward sums are the global batch's: K8's (s, sq), K9's (s, sq) and
    BN3's sums are all-reduced (with the row counts M1, M2) before they are
    finalised, and r3, K11's r2 and K12's r1 before they feed dy, p2/q2 and
    K13's p1/q1. The gradients of g1/be1, g2/be2, g3/be3 are the LOCAL r
    sums (as torch's SyncBatchNorm returns them): the trainer's gradient
    all-reduce sums them once, as it does dW1, dDW and dW2."""

    @staticmethod
    def forward(ctx, x, w1, g1, be1, dwk, g2, be2, w2, g3, be3, stride, has_expand, eps):
        B, H, W, cin = x.shape
        _check_spatial(H, W, stride)
        ce, cout = dwk.shape[-1], w2.shape[-1]
        Ho, Wo = H // stride, W // stride
        M1, M2 = B * H * W, B * Ho * Wo
        dt = x.dtype
        x = x.contiguous()
        if has_expand:
            s1_, sq1_, M1 = _global(*stats1(x, w1), count=M1)
            m1, v1 = _bn_stats_finalize(s1_, sq1_, M1)
            s1, b1 = fold_bn(g1.float(), be1.float(), m1, v1, eps)
        else:
            m1, v1 = (torch.zeros(ce, dtype=_F32, device=x.device) for _ in range(2))
            s1 = b1 = None
        d, s, sq = expand_dw(x, w1 if has_expand else None, s1, b1, dwk, stride)
        s, sq, M2 = _global(s, sq, count=M2)
        m2, v2 = _bn_stats_finalize(s, sq, M2)
        s2, b2 = fold_bn(g2.float(), be2.float(), m2, v2, eps)
        y_buf = proj(d, s2, b2, w2).to(dt)
        y32 = y_buf.float()
        m3, v3 = _bn_stats_finalize(*_global(y32.sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2)))[:2],
                                    M2)
        inv3 = torch.rsqrt(v3 + eps)
        out = (g3.float() * (y32 - m3) * inv3 + be3.float()).to(dt)
        if stride == 1 and cin == cout:
            out = x + out
        ctx.save_for_backward(x, d, y_buf, m1, v1, m2, v2, m3, v3, w1, g1, be1, dwk, g2, be2,
                              w2, g3, be3)
        ctx.conf = (stride, has_expand, eps, M1, M2)
        stats = (m1, v1, m2, v2, m3, v3)
        ctx.mark_non_differentiable(*stats)
        return (out,) + stats

    @staticmethod
    def backward(ctx, g_out, *_stat_grads):
        # The statistics' cotangents are never used: running-average updates
        # are outside autograd, as stop-gradient in flax.
        (x, d, y_buf, m1, v1, m2, v2, m3, v3, w1, g1, be1, dwk, g2, be2, w2, g3,
         be3) = ctx.saved_tensors
        stride, has_expand, eps, M1, M2 = ctx.conf
        B, H, W, cin = x.shape
        ce, cout = dwk.shape[-1], w2.shape[-1]
        dt = x.dtype

        # BN3 backward (glue, Cout wide).
        inv3 = torch.rsqrt(v3 + eps)
        yn = (y_buf.float() - m3) * inv3
        dout = g_out.float()
        r3a = dout.sum((0, 1, 2))
        r3b = (dout * yn).sum((0, 1, 2))
        r3a_g, r3b_g, _ = _global(r3a, r3b)
        dy = (g3.float() * inv3 * (dout - r3a_g / M2 - yn * (r3b_g / M2))).to(dt)

        inv2 = torch.rsqrt(v2 + eps)
        s2, b2 = fold_bn(g2.float(), be2.float(), m2, v2, eps)
        dv2, dW2, r2a, r2b = proj_bwd(d, dy, s2, b2, m2, inv2, w2)
        r2a_g, r2b_g, _ = _global(r2a, r2b)
        u2 = g2.float() * inv2
        p2 = u2 * (r2a_g / M2)
        q2 = u2 * (r2b_g / M2)

        if has_expand:
            inv1 = torch.rsqrt(v1 + eps)
            s1, b1 = fold_bn(g1.float(), be1.float(), m1, v1, eps)
            dv1, ddw, r1a, r1b = dw_bwd(x, w1, s1, b1, m1, inv1, dwk, dv2, u2, p2, q2, d, m2,
                                        inv2, stride)
            r1a_g, r1b_g, _ = _global(r1a, r1b)
            u1 = g1.float() * inv1
            dx, dW1 = expand_bwd(x, w1, m1, inv1, u1, u1 * (r1a_g / M1), u1 * (r1b_g / M1),
                                 dv1)
            dx = dx.to(dt)
            dg1, db1, dW1 = r1b.to(g1.dtype), r1a.to(be1.dtype), dW1.to(w1.dtype)
        else:
            dx, ddw, _, _ = dw_bwd(x, None, None, None, None, None, dwk, dv2, u2, p2, q2, d,
                                   m2, inv2, stride)
            dW1, dg1, db1 = torch.zeros_like(w1), torch.zeros_like(g1), torch.zeros_like(be1)
        if stride == 1 and cin == cout:
            dx = dx + g_out
        return (dx, dW1, dg1, db1, ddw.reshape(3, 3, ce).to(dwk.dtype), r2b.to(g2.dtype),
                r2a.to(be2.dtype), dW2.to(w2.dtype), r3b.to(g3.dtype), r3a.to(be3.dtype),
                None, None, None)


def fused_ir_train(x, w1, g1, be1, dwk, g2, be2, w2, g3, be3, stride: int = 1,
                   has_expand: bool = True, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Fused training-mode InvertedResidual on NHWC x [B, H, W, Cin] (f32 or
    bf16); parameters in the JAX package's layout: w1 [Cin, Ce] (zeros, with
    g1 and be1, at expansion 1, has_expand False), dwk [3, 3, Ce], w2
    [Ce, Cout], BN weights and biases per channel.

    Returns (out, (mean1, var1, mean2, var2, mean3, var3)): the batch
    statistics (biased variance) for the running averages, outside autograd.
    Gradients reach every tensor input through K11-K13."""
    out, *stats = _FusedIRTrain.apply(x, w1, g1, be1, dwk, g2, be2, w2, g3, be3, stride,
                                      has_expand, eps)
    return out, tuple(stats)
