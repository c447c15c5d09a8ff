"""Fused depthwise-3x3 + GroupNorm (+ ReLU6): hand-written Hopper kernels
and their plain versions.

Port of ``distriflow_tpu/ops/depthwise_gn.py``. MobileNetV2's depthwise
blocks run ``depthwise3x3(SAME) -> GroupNorm(8) -> affine -> ReLU6`` as one
pass over the activation: the conv output and the group statistics never
reach device memory.

- ``csrc/depthwise_gn.cu`` replaces the Pallas ``_fwd_kernel`` (forward)
  and ``_bwd_kernel`` (the ``jax.vjp`` of the same tile, which recomputes
  the forward) for bf16 NHWC activations.
- Activations are NHWC with channels in groups of 8; the depthwise kernel
  ``w`` is flax's ``[3, 3, 1, C]`` or squeezed ``[3, 3, C]``, in the
  activation dtype; ``scale``/``bias`` are the f32 GroupNorm affine.

The arithmetic is the TPU tile's (``depthwise_gn.py:141-177``): nine
products ``x * w[ky, kx]`` added in (ky, kx) order, each product and sum
rounded to the activation dtype; statistics in f32 as ``E[x]`` and
``E[x^2]``, ``rsqrt(max(E[x^2] - E[x]^2, 0) + eps)``; the affine in f32,
a cast, then ``min(max(y, 0), 6)``. Every sum over positions (the
statistics, their gradients, dscale, dbias, dw) is the f32 of the exact
sum, accumulated in f64, in the kernels and the plain versions alike: the
one-pass variance of a nearly flat group cancels, and f32 sums in two
orders would leave the two percent apart. The backward is that function's exact
derivative as ``jax.vjp`` takes it, including the ties of ReLU6: at
``y == 0`` and ``y == 6`` half the gradient passes (``jnp.maximum`` and
``jnp.minimum`` split a tie), where the unfused ``F.relu6`` passes none.

:func:`depthwise_gn_forward` and :func:`depthwise_gn_backward` launch the
kernels for CUDA tensors (or raise) and run the plain versions for CPU
tensors; each counts its launches. :func:`depthwise3x3_groupnorm` is the
differentiable entry point; it saves only ``(x, w, scale, bias)`` and
recomputes in the backward, as the JAX ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Tuple

import torch
import torch.nn.functional as F

from distriflow_tpu_torch.ops import build

GROUP_SIZE = 8  # channels are multiples of 8 by construction (_make_divisible)
MIN_CHANNELS = 8  # below one group there is nothing to normalize over
# the JAX gate's TPU scoped-VMEM limit: the port fuses exactly the shapes
# JAX fuses, so a model takes the same branch on both (the CUDA kernels
# themselves take any spatial size)
VMEM_LIMIT_BYTES = 16 * 1024 * 1024

_warned_gated: set = set()  # (h, w, c, stride) shapes already warned about

_SIGNATURES = {
    "dftt_dwgn_fwd_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "dftt_dwgn_bwd_bf16": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _same_pads(d: int, stride: int) -> Tuple[int, int]:
    """XLA SAME padding for kernel 3: odd dims at stride 2 pad (1, 1),
    even dims (0, 1)."""
    total = max((-(-d // stride) - 1) * stride + 3 - d, 0)
    return (total // 2, total - total // 2)


def _channel_block(c: int) -> int:
    """The JAX kernel's channel tile (only its VMEM estimate reads it)."""
    if c <= 512:
        return c
    for blk in range(512, 0, -128):
        if c % blk == 0:
            return blk
    return c


def _vmem_estimate_bytes(hp, wp, oh, ow, block_c, itemsize):
    est = hp * wp * block_c * itemsize
    est += 2 * oh * ow * block_c * 4
    est += oh * ow * block_c * itemsize
    return int(est * 1.5)


def _geometry(h: int, w: int, stride: int):
    """``(pads_h, pads_w, out_h, out_w)`` of a SAME 3x3 conv."""
    ph, pw = _same_pads(h, stride), _same_pads(w, stride)
    return ph, pw, (h + sum(ph) - 3) // stride + 1, (w + sum(pw) - 3) // stride + 1


def depthwise_gn_supported(h: int, w: int, c: int, stride: int = 1,
                           group_size: int = GROUP_SIZE, itemsize: int = 4) -> bool:
    """True when the fused kernel runs an ``[_, h, w, c]`` activation: the
    JAX predicate, rule for rule. Channels divisible by the group size and
    at least :data:`MIN_CHANNELS`, stride 1 or 2, at least one output
    position, and the JAX kernel's full-spatial tile within its VMEM
    estimate. Gated shapes bump ``ops_depthwise_gn_gated_total`` and warn
    once; callers take the unfused shift + GroupNorm composition."""
    ok = c >= MIN_CHANNELS and c % group_size == 0 and stride in (1, 2) and min(h, w) >= 1
    if ok:
        ph, pw, oh, ow = _geometry(h, w, stride)
        ok = oh >= 1 and ow >= 1 and _vmem_estimate_bytes(
            h + sum(ph), w + sum(pw), oh, ow, _channel_block(c), itemsize) <= VMEM_LIMIT_BYTES
    if ok:
        return True
    from distriflow_tpu_torch.obs.telemetry import get_telemetry

    get_telemetry().counter(
        "ops_depthwise_gn_gated_total",
        help="depthwise+GN shapes gated off the fused kernel").inc()
    key = (h, w, c, stride)
    if key not in _warned_gated:
        _warned_gated.add(key)
        warnings.warn(
            f"depthwise3x3_groupnorm gated off for activation {h}x{w}x{c} "
            f"stride {stride}: channels must be a multiple of {group_size} "
            f"(>= {MIN_CHANNELS}) and the full-spatial channel tile must "
            "fit the reference's VMEM estimate — running the unfused "
            "shift+GroupNorm composition instead.", stacklevel=3)
    return False


# -- plain versions ----------------------------------------------------------


def depthwise3x3(x: torch.Tensor, w3: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME depthwise 3x3 over NHWC ``x`` as nine shifted products, added in
    (ky, kx) order in ``x``'s dtype (``w3``: ``[3, 3, C]``, same dtype).
    The conv of the plain versions and of the unfused shift branch."""
    _, h, wd, _ = x.shape
    ph, pw, oh, ow = _geometry(h, wd, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    acc = None
    for ky in range(3):
        for kx in range(3):
            sl = xp[:, ky:ky + (oh - 1) * stride + 1:stride, kx:kx + (ow - 1) * stride + 1:stride]
            term = sl * w3[ky, kx]
            acc = term if acc is None else acc + term
    return acc


def _sum(t: torch.Tensor, dims) -> torch.Tensor:
    """The f32 of the exact sum (accumulated in f64): the same bits in any
    order, as the kernels' f64 accumulators give."""
    return t.double().sum(dim=dims, keepdim=True).float()


def _stats(acc: torch.Tensor, group_size: int, eps: float):
    """``(xg [B, P, G, gs] f32, mean, E[x^2] - mean^2, inv)`` per group;
    the means are f32 of the exact means."""
    b, oh, ow, c = acc.shape
    xg = acc.reshape(b, oh * ow, c // group_size, group_size).float()
    m = xg.double().mean(dim=(1, 3), keepdim=True).float()
    m2 = (xg * xg).double().mean(dim=(1, 3), keepdim=True).float()
    var = m2 - m * m
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return xg, m, var, inv


def _w3(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(3, 3, w.shape[-1])


def depthwise3x3_groupnorm_reference(x, w, scale, bias, stride: int = 1, eps: float = 1e-6,
                                     group_size: int = GROUP_SIZE, relu6: bool = True
                                     ) -> torch.Tensor:
    """Plain version of the forward kernel: ``[B, oh, ow, C]`` in ``x``'s
    dtype."""
    acc = depthwise3x3(x, _w3(w), stride)
    xg, m, _, inv = _stats(acc, group_size, eps)
    y = ((xg - m) * inv).reshape(acc.shape)
    y = (y * scale.float() + bias.float()).to(x.dtype)
    return torch.clamp(y, 0.0, 6.0) if relu6 else y


def _half_at_ties(v: torch.Tensor, lo: bool, hi: bool) -> torch.Tensor:
    """JAX's derivative factor of max/min at a tie: 1 inside, 0.5 on a
    bound, 0 outside (``lo``/``hi`` pick the bounds 0 and 6)."""
    one = torch.ones_like(v)
    f = one
    if lo:
        f = torch.where(v > 0, one, torch.where(v == 0, 0.5 * one, 0.0 * one))
    if hi:
        f = f * torch.where(v < 6, one, torch.where(v == 6, 0.5 * one, 0.0 * one))
    return f


def _dacc_reference(x, w, scale, bias, g, stride, eps, group_size, relu6, drop_stats=False):
    """The backward up to the conv: ``(acc, dacc in x's dtype, dscale and
    dbias per batch [B, C] f32)``. ``drop_stats`` treats the mean and inv
    as constants, a deliberately wrong gradient for the limit checks."""
    acc = depthwise3x3(x, _w3(w), stride)
    b, oh, ow, c = acc.shape
    xg, m, var, inv = _stats(acc, group_size, eps)
    xc = xg - m
    yn = (xc * inv).reshape(acc.shape)
    y = (yn * scale.float() + bias.float()).to(x.dtype)
    dz = g.float() * _half_at_ties(y.float(), True, True) if relu6 else g.float()
    dscale = _sum(dz * yn, (1, 2))[:, 0, 0]
    dbias = _sum(dz, (1, 2))[:, 0, 0]
    dyn = (dz * scale.float()).reshape(xg.shape)
    dxc = dyn * inv
    if drop_stats:
        return acc, dxc.reshape(acc.shape).to(x.dtype), dscale, dbias
    n = xg.shape[1] * xg.shape[3]
    dinv = _sum(dyn * xc, (1, 3))
    dvar = dinv * (-0.5 * (inv / (torch.clamp(var, min=0.0) + eps)))
    dvar = dvar * _half_at_ties(var, True, False)
    dm = -_sum(dxc, (1, 3)) - 2.0 * dvar * m
    dxg = dxc + 2.0 * xg * (dvar / n) + dm / n
    return acc, dxg.reshape(acc.shape).to(x.dtype), dscale, dbias


def _conv_transpose_reference(x, w3, dacc, stride):
    """``(dx, dw per batch [B, 3, 3, C] f32)`` of the nine shifted products.
    dx sums the nine contributions in the activation dtype from the last
    tap (2, 2) to the first, the order in which ``jax.vjp`` accumulates
    them (bitwise equal to the interpreted Pallas kernel at bf16). Each dw
    term is the f32 of the exact sum of rounded products ``dacc * x``,
    rounded to the activation dtype per batch element (the interpreter on
    the CPU adds them in bf16 one by one instead)."""
    b, h, wd, c = x.shape
    ph, pw, oh, ow = _geometry(h, wd, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    dxp = torch.zeros_like(xp)
    dw = torch.empty(b, 3, 3, c, dtype=torch.float32, device=x.device)
    for ky in (2, 1, 0):
        for kx in (2, 1, 0):
            rows = slice(ky, ky + (oh - 1) * stride + 1, stride)
            cols = slice(kx, kx + (ow - 1) * stride + 1, stride)
            dxp[:, rows, cols] = dxp[:, rows, cols] + dacc * w3[ky, kx]
            dw[:, ky, kx] = _sum(dacc * xp[:, rows, cols], (1, 2))[:, 0, 0].to(x.dtype).float()
    return dxp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + wd], dw


def depthwise3x3_groupnorm_backward_reference(x, w, scale, bias, g, stride: int = 1,
                                              eps: float = 1e-6, group_size: int = GROUP_SIZE,
                                              relu6: bool = True, drop_stats: bool = False):
    """Plain version of the backward kernel and the sum over the batch:
    ``(dx in x's dtype, dw like w, dscale, dbias like scale and bias)``."""
    _, dacc, dsp, dbp = _dacc_reference(x, w, scale, bias, g, stride, eps, group_size, relu6,
                                        drop_stats)
    dx, dwp = _conv_transpose_reference(x, _w3(w), dacc, stride)
    return _reduce(dx, dwp, dsp, dbp, w, scale, bias)


def _reduce(dx, dwp, dsp, dbp, w, scale, bias):
    """Sum the per-batch partials (fixed order, as JAX sums them outside
    its kernel) and cast each to its parameter's dtype."""
    return (dx, dwp.sum(0).reshape(w.shape).to(w.dtype), dsp.sum(0).to(scale.dtype),
            dbp.sum(0).to(bias.dtype))


# -- the kernels -------------------------------------------------------------


def _check(what: str, x, w, scale, bias, stride, group_size, g=None) -> None:
    """Raise unless the kernels take these tensors: contiguous bf16 NHWC
    ``x`` (and ``g``) on CUDA, a contiguous bf16 ``[3, 3, C]`` kernel,
    contiguous f32 ``[C]`` affine, groups of 8, stride 1 or 2."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"{what}: the kernel takes contiguous bf16 NHWC x, got "
                        f"{x.dtype} {tuple(x.shape)}")
    c = x.shape[3]
    if group_size != GROUP_SIZE or c % GROUP_SIZE or c < MIN_CHANNELS or stride not in (1, 2):
        raise ValueError(f"{what}: the kernel takes groups of {GROUP_SIZE} channels and "
                         f"stride 1 or 2, got C={c}, group_size={group_size}, stride={stride}")
    if (w.numel() != 9 * c or w.shape[-1] != c or w.dtype != torch.bfloat16
            or not w.is_contiguous() or w.device != x.device):
        raise ValueError(f"{what}: w must be a contiguous bf16 [3, 3, (1,) {c}] on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{what}: {name} must be a contiguous f32 [{c}] on {x.device}")
    if g is not None:
        _, _, oh, ow = _geometry(x.shape[1], x.shape[2], stride)
        want = (x.shape[0], oh, ow, c)
        if g.shape != want or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
            raise ValueError(f"{what}: g must be a contiguous bf16 {want} on {x.device}")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if g is None else (g,))):
        raise ValueError(f"{what}: x, w and g must start on a 16-byte boundary (16-byte loads)")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"{what}: the kernel's grid takes a batch of 1 to 65535, got {x.shape[0]}")


def depthwise_gn_forward(x, w, scale, bias, stride: int = 1, eps: float = 1e-6,
                         group_size: int = GROUP_SIZE, relu6: bool = True) -> torch.Tensor:
    """The fused forward: the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return depthwise3x3_groupnorm_reference(x, w, scale, bias, stride, eps, group_size, relu6)
    _check("depthwise_gn_forward", x, w, scale, bias, stride, group_size)
    b, h, wd, c = x.shape
    _, _, oh, ow = _geometry(h, wd, stride)
    out = torch.empty(b, oh, ow, c, dtype=x.dtype, device=x.device)
    lib = build.load("depthwise_gn", _SIGNATURES)
    rc = lib.dftt_dwgn_fwd_bf16(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, h, wd, c, stride, eps, int(relu6), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "depthwise_gn_forward")
    depthwise_gn_forward.launches += 1
    return out


def depthwise_gn_backward(x, w, scale, bias, g, stride: int = 1, eps: float = 1e-6,
                          group_size: int = GROUP_SIZE, relu6: bool = True):
    """The fused backward for the upstream gradient ``g``: ``(dx, dw,
    dscale, dbias)``, each in its input's dtype and shape. The kernel
    writes dx and per-batch f32 partials of dw, dscale and dbias; they
    are summed over the batch here."""
    if x.device.type == "cpu":
        return depthwise3x3_groupnorm_backward_reference(x, w, scale, bias, g, stride, eps,
                                                         group_size, relu6)
    _check("depthwise_gn_backward", x, w, scale, bias, stride, group_size, g)
    b, h, wd, c = x.shape
    _, _, oh, ow = _geometry(h, wd, stride)
    dx = torch.empty_like(x)
    dacc = torch.empty(b, oh, ow, c, dtype=x.dtype, device=x.device)  # scratch
    dwp = torch.empty(b, 3, 3, c, dtype=torch.float32, device=x.device)
    dsp = torch.empty(b, c, dtype=torch.float32, device=x.device)
    dbp = torch.empty(b, c, dtype=torch.float32, device=x.device)
    lib = build.load("depthwise_gn", _SIGNATURES)
    rc = lib.dftt_dwgn_bwd_bf16(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dacc.data_ptr(), dwp.data_ptr(), dsp.data_ptr(), dbp.data_ptr(),
        b, h, wd, c, stride, eps, int(relu6), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "depthwise_gn_backward")
    depthwise_gn_backward.launches += 1
    return _reduce(dx, dwp, dsp, dbp, w, scale, bias)


#: kernel launches since the count was last set to 0
depthwise_gn_forward.launches = 0
depthwise_gn_backward.launches = 0


class _DepthwiseGN(torch.autograd.Function):
    """Saves ``(x, w, scale, bias)`` and recomputes in the backward (JAX:
    the ``custom_vjp`` of ``depthwise3x3_groupnorm``)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, stride, eps, group_size, relu6):
        ctx.save_for_backward(x, w, scale, bias)
        ctx.args = (stride, eps, group_size, relu6)
        return depthwise_gn_forward(x, w, scale, bias, stride, eps, group_size, relu6)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias = ctx.saved_tensors
        grads = depthwise_gn_backward(x, w, scale, bias, g.contiguous(), *ctx.args)
        return (*grads, None, None, None, None)


def depthwise3x3_groupnorm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, stride: int = 1, eps: float = 1e-6,
                           group_size: int = GROUP_SIZE, relu6: bool = True) -> torch.Tensor:
    """Fused ``depthwise3x3(SAME) -> GroupNorm -> ReLU6`` over NHWC ``x``,
    differentiable. ``w``: ``[3, 3, 1, C]`` or ``[3, 3, C]`` in ``x``'s
    dtype; ``scale``/``bias``: f32 ``[C]``. Callers consult
    :func:`depthwise_gn_supported` first."""
    return _DepthwiseGN.apply(x, w, scale, bias, stride, eps, group_size, relu6)
