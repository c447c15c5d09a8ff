"""Port of ``distriflow_tpu/models/mobilenet.py``: MobileNetV2 (BASELINE
config #5, the ImageNet-subset workload).

The same network as the JAX package, module for module, with the flax
module names (``_ConvNorm_0``, ``InvertedResidual_3._ConvNorm_1``,
``Conv_0``, ``GroupNorm_0``, ``Dense_0``, ...) as the ``nn.Module``
names, so a flax params tree maps onto the ``state_dict`` path for path
(:func:`distriflow_tpu_torch.models.convert.mobilenet_params_from_jax`).

- Activations stay NHWC, as in JAX: a batch the JAX spec takes goes in
  unchanged, and the fused depthwise kernel reads contiguous NHWC.
- Parameters are f32 masters cast to ``dtype`` on every call (flax's
  ``param_dtype`` float32 with a compute ``dtype``).
- Full convolutions (the stem 3x3, the 1x1 pointwise convs, the
  ``"conv"`` depthwise) run through ``F.conv2d`` on an NHWC view with
  explicit SAME pads: PyTorch's symmetric ``padding`` differs from XLA's
  SAME at stride 2 on even sizes, which pads (0, 1). Their kernels are
  kept in PyTorch's OIHW layout; the fused and shift depthwise kernels as
  ``[3, 3, C]``.
- ``depthwise_impl``: ``"conv"`` (grouped ``F.conv2d``), ``"shift"`` (nine
  shifted products, :func:`_depthwise3x3_shift`) or ``"fused"`` (the depthwise+GroupNorm+ReLU6 kernels where
  ``depthwise_gn_supported`` passes, else the shift + one-pass GroupNorm
  composition, as ``mobilenet.py:219-228``). ``gn_impl``: ``"flax"``
  (flax ``GroupNorm(group_size=8)``: fast variance, eps 1e-6, f32
  statistics) or ``"onepass"``.
- ``norm="batch"``: :class:`FrozenBatchNorm`, statistics as ``frozen_``
  parameters the optimizer never moves.

The fused kernels take bf16 only: a fused model in another dtype on CUDA
raises when it is built.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from distriflow_tpu_torch.models.base import ModelSpec
from distriflow_tpu_torch.models.module_model import spec_from_module
from distriflow_tpu_torch.ops.depthwise_gn import (
    depthwise3x3,
    depthwise3x3_groupnorm,
    depthwise_gn_supported,
)

# (expansion t, out channels c, repeats n, first-block stride s): the
# standard MobileNetV2 inverted-residual schedule
V2_SCHEDULE: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts to a multiple of ``divisor``, never dropping
    below 90% of the requested width (standard MobileNet rule)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


def _same_pad(d: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-d // stride) - 1) * stride + k - d, 0)
    return (total // 2, total - total // 2)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class Conv(nn.Module):
    """flax ``nn.Conv(padding="SAME")`` over NHWC, computed in ``dtype``;
    ``kernel`` is f32 OIHW. Without a bias unless ``use_bias`` (MobileNet
    passes ``use_bias=False`` to flax; the zoo keeps flax's default): a
    bias of zeros, added in ``dtype`` after the convolution, as flax adds
    it."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int], stride: int,
                 groups: int, dtype: torch.dtype, use_bias: bool = False):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.kernel = nn.Parameter(torch.empty(features, in_ch // groups, *kernel))
        _lecun_normal_(self.kernel, kernel[0] * kernel[1] * (in_ch // groups))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[2:]
        ph, pw = _same_pad(x.shape[1], kh, self.stride), _same_pad(x.shape[2], kw, self.stride)
        x = F.pad(x.to(self.dtype), (0, 0, pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(self.dtype), stride=self.stride,
                     groups=self.groups).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class _Affine(nn.Module):
    """Per-channel f32 ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class GroupNorm(_Affine):
    """flax ``GroupNorm(num_groups=None, group_size=8)``: f32 statistics
    with the fast variance ``max(E[x^2] - E[x]^2, 0)``, eps 1e-6,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast to ``dtype``."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__(c)
        self.dtype, self.eps = dtype, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        xg = x.reshape(b, h, w, c // 8, 8).float()
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.reshape(c // 8, 8)
        y = (xg - mean) * mul + self.bias.reshape(c // 8, 8)
        return y.reshape(b, h, w, c).to(self.dtype)


def _depthwise3x3_shift(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise 3x3 (SAME, parity-aware pads) as nine shifted products in
    ``x``'s dtype; ``w``: ``[3, 3, C]`` or flax's ``[3, 3, 1, C]``."""
    return depthwise3x3(x, w.reshape(3, 3, w.shape[-1]), stride)


def _onepass_gn_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """The one-pass GroupNorm with explicit affine, cast to ``x``'s dtype:
    the unfused fallback of the fused branch."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, c // 8, 8).float()
    m = xg.mean(dim=(1, 3), keepdim=True)
    m2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    inv = torch.rsqrt(torch.clamp(m2 - m * m, min=0.0) + eps)
    y = ((xg - m) * inv).reshape(b, h, w, c)
    return (y * scale + bias).to(x.dtype)


class _OnePassGroupNorm(_Affine):
    """GroupNorm(group_size=8) from single-pass ``E[x]``/``E[x^2]``
    statistics (JAX ``_OnePassGroupNorm``), cast to ``dtype``."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__(c)
        self.dtype, self.eps = dtype, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _onepass_gn_affine(x, self.scale, self.bias, self.eps).to(self.dtype)


class FrozenBatchNorm(_Affine):
    """BatchNorm with its moving statistics as frozen parameters:
    ``x * inv + shift`` in ``dtype``, where ``frozen_mean``/``frozen_var``
    get no gradient and, by their ``frozen_`` names, no optimizer update."""

    def __init__(self, c: int, dtype: torch.dtype, eps: float = 1e-3):
        super().__init__(c)
        self.dtype, self.eps = dtype, eps
        self.frozen_mean = nn.Parameter(torch.zeros(c))
        self.frozen_var = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.frozen_mean.detach(), self.frozen_var.detach()
        root = torch.sqrt(var + self.eps)
        inv = (self.scale / root).to(self.dtype)
        shift = (self.bias - mean * self.scale / root).to(self.dtype)
        return x * inv + shift


class _ConvNorm(nn.Module):
    """conv -> norm (GroupNorm | frozen BatchNorm) -> optional ReLU6."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int] = (1, 1),
                 stride: int = 1, groups: int = 1, act: bool = True, norm: str = "group",
                 dtype: torch.dtype = torch.float32, depthwise_impl: str = "conv",
                 gn_impl: str = "flax"):
        super().__init__()
        self.stride, self.act, self.dtype = stride, act, dtype
        depthwise = kernel == (3, 3) and groups == in_ch and features == in_ch
        self.fused = depthwise_impl == "fused" and depthwise and norm == "group"
        self.shift = depthwise_impl == "shift" and depthwise
        if self.fused or self.shift:
            # the flax [3, 3, 1, C] kernel, squeezed (mobilenet.py:208-213)
            self.kernel = nn.Parameter(torch.empty(3, 3, in_ch))
            _lecun_normal_(self.kernel, 9)
        if self.fused:
            self.scale = nn.Parameter(torch.ones(in_ch))
            self.bias = nn.Parameter(torch.zeros(in_ch))
            return
        if not self.shift:
            self.add_module("Conv_0", Conv(in_ch, features, kernel, stride, groups, dtype))
        if norm == "batch":
            self._norm = "FrozenBatchNorm_0"
            self.add_module(self._norm, FrozenBatchNorm(features, dtype))
        elif norm == "group":
            self._norm = "_OnePassGroupNorm_0" if gn_impl == "onepass" else "GroupNorm_0"
            cls = _OnePassGroupNorm if gn_impl == "onepass" else GroupNorm
            self.add_module(self._norm, cls(features, dtype))
        else:  # validate here too: the module classes are public
            raise ValueError(f"norm must be 'group' or 'batch', got {norm!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            w = self.kernel.to(self.dtype)
            xd = x.to(self.dtype).contiguous()
            _, h, wd, c = xd.shape
            if depthwise_gn_supported(h, wd, c, self.stride, itemsize=_itemsize(self.dtype)):
                return depthwise3x3_groupnorm(xd, w, self.scale, self.bias, self.stride, 1e-6,
                                              8, self.act)
            # gated shape: the same math unfused (shift products, one-pass GN)
            y = _onepass_gn_affine(_depthwise3x3_shift(xd, w, self.stride), self.scale, self.bias)
            return F.relu6(y) if self.act else y
        if self.shift:
            x = _depthwise3x3_shift(x.to(self.dtype), self.kernel.to(self.dtype), self.stride)
        else:
            x = self._modules["Conv_0"](x)
        x = self._modules[self._norm](x)
        return F.relu6(x) if self.act else x


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 -> project 1x1, residual when shapes match."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, expand: int = 6,
                 norm: str = "group", dtype: torch.dtype = torch.float32,
                 depthwise_impl: str = "conv", gn_impl: str = "flax"):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        hidden = in_ch * expand
        layers = []
        if expand != 1:
            layers.append(_ConvNorm(in_ch, hidden, norm=norm, dtype=dtype, gn_impl=gn_impl))
        layers.append(_ConvNorm(hidden, hidden, kernel=(3, 3), stride=stride, groups=hidden,
                                norm=norm, dtype=dtype, depthwise_impl=depthwise_impl,
                                gn_impl=gn_impl))
        layers.append(_ConvNorm(hidden, out_ch, act=False, norm=norm, dtype=dtype,
                                gn_impl=gn_impl))
        for i, layer in enumerate(layers):
            self.add_module(f"_ConvNorm_{i}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.children():
            h = layer(h)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """NHWC images ``[B, H, W, 3]`` -> logits ``[B, classes]`` in ``dtype``."""

    def __init__(self, classes: int = 1000, width: float = 1.0,
                 schedule: Sequence[Tuple[int, int, int, int]] = V2_SCHEDULE,
                 norm: str = "group", dtype: torch.dtype = torch.float32,
                 depthwise_impl: str = "conv", gn_impl: str = "flax", in_ch: int = 3):
        super().__init__()
        self.dtype = dtype
        ch = _make_divisible(32 * width)
        self.add_module("_ConvNorm_0", _ConvNorm(in_ch, ch, kernel=(3, 3), stride=2, norm=norm,
                                                 dtype=dtype, gn_impl=gn_impl))
        i = 0
        for t, c, n, s in schedule:
            out_ch = _make_divisible(c * width)
            for j in range(n):
                self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                    ch, out_ch, stride=s if j == 0 else 1, expand=t, norm=norm, dtype=dtype,
                    depthwise_impl=depthwise_impl, gn_impl=gn_impl))
                ch, i = out_ch, i + 1
        head = _make_divisible(1280 * max(1.0, width))
        self.add_module("_ConvNorm_1", _ConvNorm(ch, head, norm=norm, dtype=dtype,
                                                 gn_impl=gn_impl))
        self.add_module("Dense_0", Dense(head, classes, dtype))
        self.blocks = [m for n, m in self.named_children() if n.startswith("InvertedResidual_")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._modules["_ConvNorm_0"](x.to(self.dtype))
        for block in self.blocks:
            x = block(x)
        x = self._modules["_ConvNorm_1"](x)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)  # global average pool, f32 sum
        return self._modules["Dense_0"](x)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``; ``kernel`` is
    f32 ``[in, out]``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        _lecun_normal_(self.kernel, in_features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


def mobilenet_v2(
    image_size: int = 224,
    classes: int = 1000,
    width: float = 1.0,
    norm: str = "group",
    dtype: torch.dtype = torch.float32,
    depthwise_impl: str = "conv",
    gn_impl: str = "flax",
    device: Optional[Union[str, torch.device]] = None,
) -> ModelSpec:
    """BASELINE config #5 model on ``device`` (``cuda`` by default); ``x``
    = NHWC images ``[B, image_size, image_size, 3]``. ``norm="group"``
    trains from scratch; ``norm="batch"`` is the frozen-BatchNorm variant."""
    from distriflow_tpu_torch.utils.device import resolve_device

    if norm not in ("group", "batch"):
        raise ValueError(f"norm must be 'group' or 'batch', got {norm!r}")
    if depthwise_impl not in ("conv", "shift", "fused"):
        raise ValueError(
            f"depthwise_impl must be 'conv', 'shift' or 'fused', got {depthwise_impl!r}")
    if depthwise_impl == "fused" and norm != "group":
        raise ValueError(
            "depthwise_impl='fused' fuses GroupNorm into the kernel and "
            f"requires norm='group', got norm={norm!r}")
    if gn_impl not in ("flax", "onepass"):
        raise ValueError(f"gn_impl must be 'flax' or 'onepass', got {gn_impl!r}")
    dev = resolve_device(device)
    if depthwise_impl == "fused" and dev.type == "cuda" and dtype != torch.bfloat16:
        raise NotImplementedError(
            f"no CUDA depthwise+GroupNorm kernel for {dtype} activations: it takes bf16; "
            "use dtype=torch.bfloat16 or depthwise_impl='shift'")
    return spec_from_module(
        lambda: MobileNetV2(classes=classes, width=width, norm=norm, dtype=dtype,
                            depthwise_impl=depthwise_impl, gn_impl=gn_impl),
        input_shape=(image_size, image_size, 3),
        output_shape=(classes,),
        name="mobilenet_v2",
        device=dev,
    )
