"""Port of ``distriflow_tpu/models/keras_import.py``: the tfjs-layers / Keras
``model.json`` (and ``.h5``) importer.

The reference loads its models from a string URL through
``tf.loadLayersModel`` (``fetchModel``); the JAX package parses the same
files into a ``ModelSpec``, and so does this module. The topology lowers
to a list of layer functions ``fn(params, x)`` over a ``{layer: {weight:
tensor}}`` tree, as in JAX, run eagerly on tensors; convolutions and
pools go to ``F.conv2d`` and friends (JAX computes them with ``lax``,
outside any Pallas kernel). The same layers, the same errors and the same
deliberate semantics:

- **Dropout is identity** (the reference's ``fit`` runs its layers in
  inference mode).
- **A trailing softmax is stripped** by default (``logits_output=True``);
  the spec is named ``keras:<file>:logits`` then.
- **BatchNormalization uses its stored moving statistics**, and they are
  parameters like any other: they take gradients and optimizer updates,
  as they do under ``jax.grad`` of JAX's params tree.

PyTorch idiom inside: ``init(seed)`` returns a :class:`KerasModel`, an
``nn.Module`` holding every weight as an f32 master parameter named
``<layer>.<weight>``; ``apply`` casts them to the spec's ``dtype`` on each
call, the values JAX holds in that dtype. The wire carries JAX's tree
(``{layer: {weight: array}}`` in ``dtype``), so the keystr paths and bytes
are JAX's. A cold init draws from a ``torch.Generator`` seeded by ``seed``
with the same Keras initializers, so its bits differ from JAX's by design.
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distriflow_tpu_torch.models.base import ModelSpec

Params = Dict[str, Dict[str, torch.Tensor]]
LayerFn = Callable[[Params, torch.Tensor], torch.Tensor]
Init = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]
Device = Optional[Union[str, torch.device]]

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "sigmoid": torch.sigmoid,
    # Keras' hard_sigmoid is clip(0.2x + 0.5, 0, 1), not relu6(x + 3) / 6:
    # old tfjs LSTM/GRU exports default to it
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "swish": F.silu,  # tf.keras swish == silu (x * sigmoid(x))
    "silu": F.silu,
    "exponential": torch.exp,
}

_DTYPES = {"float32": np.float32, "int32": np.int32, "bool": np.bool_, "uint8": np.uint8}


def _activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name or "linear"
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


# -- initializers (jax.nn.initializers' formulas, drawn from a generator) ----


def _fans(shape: Tuple[int, ...]) -> Tuple[float, float]:
    """``jax.nn.initializers``' fans: in axis -2, out axis -1, the rest the
    receptive field."""
    if len(shape) <= 1:
        raise ValueError(f"can't compute input and output sizes of a {len(shape)}-dimensional "
                         "weights tensor; must be at least 2D")
    receptive = math.prod(shape[:-2])
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _truncated_normal(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """A standard normal truncated to [-2, 2] (jax.random.truncated_normal)."""
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out


def _variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    def init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
        fan_in, fan_out = _fans(shape)
        n = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
        var = scale / n
        if distribution == "uniform":
            limit = math.sqrt(3.0 * var)
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit
        if distribution == "truncated_normal":
            # the std of a unit normal truncated to [-2, 2]
            return _truncated_normal(gen, shape) * (math.sqrt(var) / 0.87962566103423978)
        return torch.randn(shape, generator=gen) * math.sqrt(var)

    return init


def _orthogonal(gain: float) -> Init:
    """``jax.nn.initializers.orthogonal(scale=gain)``, columns on the last axis."""

    def init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        a = torch.randn((n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols),
                        generator=gen, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (gain * q).reshape(shape).float()

    return init


def _constant(value: float) -> Init:
    return lambda gen, shape: torch.full(shape, float(value))


def _initializer(cfg: Optional[Dict[str, Any]]) -> Init:
    """A Keras initializer config -> ``init(generator, shape)`` (f32)."""
    if not cfg:
        return _constant(0.0)
    cls = cfg.get("class_name", "Zeros")
    c = cfg.get("config", {})
    if cls in ("Zeros", "zeros"):
        return _constant(0.0)
    if cls in ("Ones", "ones"):
        return _constant(1.0)
    if cls == "Constant":
        return _constant(c.get("value", 0.0))
    if cls == "VarianceScaling":
        return _variance_scaling(
            c.get("scale", 1.0),
            {"fan_in": "fan_in", "fan_out": "fan_out", "fan_avg": "fan_avg"}[
                c.get("mode", "fan_avg")],
            {"uniform": "uniform", "normal": "truncated_normal",
             "truncated_normal": "truncated_normal", "untruncated_normal": "normal"}[
                c.get("distribution", "uniform")])
    if cls == "Orthogonal":
        return _orthogonal(c.get("gain", 1.0))
    if cls == "GlorotUniform":
        return _variance_scaling(1.0, "fan_avg", "uniform")
    if cls == "GlorotNormal":
        return _variance_scaling(1.0, "fan_avg", "truncated_normal")
    if cls == "HeUniform":
        return _variance_scaling(2.0, "fan_in", "uniform")
    if cls == "HeNormal":
        return _variance_scaling(2.0, "fan_in", "truncated_normal")
    if cls == "RandomUniform":
        lo, hi = c.get("minval", -0.05), c.get("maxval", 0.05)
        return lambda gen, shape: lo + (hi - lo) * torch.rand(shape, generator=gen)
    if cls == "RandomNormal":
        mean, std = c.get("mean", 0.0), c.get("stddev", 0.05)
        return lambda gen, shape: mean + std * torch.randn(shape, generator=gen)
    raise ValueError(f"unsupported initializer {cls!r}")


def _kernel_init(cfg: Dict[str, Any]) -> Init:
    """Kernel initializer with the Keras default (glorot_uniform) when the
    config omits it (``_initializer(None)`` is zeros)."""
    return _initializer(cfg.get("kernel_initializer") or {"class_name": "GlorotUniform"})


def _scan_rnn(step: Callable, carry: Tuple[torch.Tensor, ...], x: torch.Tensor,
              ret_seq: bool) -> torch.Tensor:
    """Run ``step(carry, x_t) -> (carry, h_t)`` over the time axis of ``x
    [B, S, C]`` (JAX's ``lax.scan``, as a loop)."""
    hs = []
    for t in range(x.shape[1]):
        carry, h = step(carry, x[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1) if ret_seq else carry[0]


# -- shape and layout helpers ----------------------------------------------


def _feature_shape(batch_input_shape, where: str) -> Tuple[int, ...]:
    """batch_input_shape -> feature shape; dynamic (null) dims raise."""
    dims = batch_input_shape[1:]
    if any(d is None for d in dims):
        raise ValueError(
            f"{where}: batch_input_shape {batch_input_shape} has dynamic "
            "(null) dimensions; this importer builds static-shape programs "
            "— pass input_shape= with concrete sizes")
    return tuple(int(d) for d in dims)


def _pair(v: Any) -> Tuple[int, int]:
    """Keras int-or-(before, after) option -> a concrete (before, after)."""
    if isinstance(v, int):
        return v, v
    return int(v[0]), int(v[1])


def _pool_padding(cfg: Dict[str, Any]) -> str:
    return {"valid": "VALID", "same": "SAME"}[cfg.get("padding", "valid")]


def _conv_dim(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def _same_pad(size: int, extent: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding (before, after) of one spatial axis."""
    total = max((-(-size // stride) - 1) * stride + extent - size, 0)
    return total // 2, total - total // 2


def _conv2d(x: torch.Tensor, k: torch.Tensor, strides: Tuple[int, int], padding: str,
            dilation: Tuple[int, int] = (1, 1), groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` over NHWC ``x`` and an HWIO kernel."""
    kh, kw = k.shape[:2]
    if padding == "SAME":
        ph = _same_pad(x.shape[1], (kh - 1) * dilation[0] + 1, strides[0])
        pw = _same_pad(x.shape[2], (kw - 1) * dilation[1] + 1, strides[1])
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=strides,
                 dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def _depthwise(x: torch.Tensor, dk: torch.Tensor, cin: int, mult: int, strides, padding,
               dilation) -> torch.Tensor:
    """A depthwise conv of a ``(kh, kw, cin, mult)`` kernel. TF's output
    channel order is channel-major (``c * mult + m``): the C-order flatten
    of the trailing (cin, mult) dims, no transpose."""
    dk = dk.to(x.dtype).reshape(dk.shape[0], dk.shape[1], 1, cin * mult)
    return _conv2d(x, dk, strides, padding, dilation, groups=cin)


def _window(x: torch.Tensor, window: Tuple[int, ...], strides: Tuple[int, ...], padding: str,
            reducer: str) -> torch.Tensor:
    """``lax.reduce_window`` max or mean over the spatial axes of a
    channels-last ``x`` (1 or 2 of them); a ``SAME`` mean divides by the
    count of real (unpadded) elements, as JAX's does."""
    nd = len(window)
    xc = x.movedim(-1, 1)  # channels first
    if nd == 1:
        xc, window, strides = xc.unsqueeze(2), (1,) + window, (1,) + strides
    pads: Tuple[int, ...] = ()
    if padding == "SAME":
        for size, k, s in reversed(list(zip(xc.shape[2:], window, strides))):
            pads += _same_pad(size, k, s)
    if reducer == "max":
        if pads:
            xc = F.pad(xc, pads, value=-math.inf)
        y = F.max_pool2d(xc, window, strides)
    elif not pads:
        y = F.avg_pool2d(xc, window, strides)
    else:
        summed = F.avg_pool2d(F.pad(xc, pads), window, strides, divisor_override=1)
        counts = F.avg_pool2d(F.pad(torch.ones_like(xc[:1, :1]), pads), window, strides,
                              divisor_override=1)
        y = summed / counts
    if nd == 1:
        y = y.squeeze(2)
    return y.movedim(1, -1)


class _Builder:
    """Walks a layer list, producing each layer's weight initializers and a
    pure forward function ``fn(params, x)``; the feature shape (no batch)
    is tracked symbolically, so fan-ins are checked when parsed."""

    def __init__(self):
        self.inits: Dict[str, Dict[str, Tuple[Tuple[int, ...], Init]]] = {}
        self.fns: List[LayerFn] = []
        self.names: List[str] = []  # resolved layer name per fn (1:1 with fns)
        self.shape: Optional[Tuple[int, ...]] = None  # feature shape, no batch
        self.integer_input = False  # Embedding-first models take raw tokens
        self._consumed_input = False  # a non-InputLayer fn has seen the input
        self.allow_shared = False  # graph mode: shared-layer re-lowering OK

    # -- helpers -----------------------------------------------------------

    def _need_shape(self, layer: str) -> Tuple[int, ...]:
        if self.shape is None:
            raise ValueError(
                f"layer {layer!r} needs a known input shape; the first layer "
                "must carry batch_input_shape (tfjs always exports it) or "
                "pass input_shape= to spec_from_keras_json")
        return self.shape

    def _register(self, name: str, weights: Dict[str, Tuple[Tuple[int, ...], Init]]) -> None:
        if name in self.inits:
            # graph mode only: a layer called at several nodes re-lowers
            # under its one name with ONE weight set, legal iff the shapes
            # agree; in a Sequential model a clash is two distinct layers
            old = {w: s for w, (s, _) in self.inits[name].items()}
            new = {w: s for w, (s, _) in weights.items()}
            if self.allow_shared and old == new:
                return
            raise ValueError(
                f"duplicate layer name {name!r}"
                + (f": shared-layer weight shapes disagree: {old} vs {new}"
                   if self.allow_shared else ""))
        self.inits[name] = weights

    # -- layer lowerings ---------------------------------------------------

    def add(self, class_name: str, cfg: Dict[str, Any]) -> None:
        name = cfg.get("name", f"{class_name.lower()}_{len(self.fns)}")
        if self.shape is None and "batch_input_shape" in cfg:
            self.shape = _feature_shape(cfg["batch_input_shape"], name)
        handler = getattr(self, f"_add_{class_name}", None)
        if handler is None:
            raise ValueError(
                f"unsupported layer {class_name!r}; supported: Conv1D/2D, "
                "DepthwiseConv2D, SeparableConv2D, Conv2DTranspose, UpSampling2D, Dense, "
                "LeakyReLU, PReLU, ELU, Softmax, Cropping1D/2D, ZeroPadding1D, Permute, "
                "RepeatVector, TimeDistributed(Dense/...), "
                "Embedding, SimpleRNN, LSTM, GRU, Bidirectional, Activation, "
                "ReLU, Max/AveragePooling1D/2D, GlobalAverage/MaxPooling1D/2D, "
                "Flatten, Reshape, ZeroPadding2D, Dropout, SpatialDropout1D, "
                "BatchNormalization, LayerNormalization, InputLayer "
                "(+ Add/Subtract/Multiply/Average/Maximum/Minimum/"
                "Concatenate in Functional graphs)")
        handler(name, cfg)
        self.names.append(name)  # every handler appends exactly one fn
        assert len(self.names) == len(self.fns)
        if class_name != "InputLayer":
            self._consumed_input = True

    def _bias(self, weights, cfg, shape) -> None:
        if cfg.get("use_bias", True):
            weights["bias"] = (shape, _initializer(cfg.get("bias_initializer")))

    def _add_Conv2D(self, name: str, cfg: Dict[str, Any]) -> None:
        h, w, cin = self._need_shape(name)
        kh, kw = (int(d) for d in cfg["kernel_size"])
        filters = int(cfg["filters"])
        strides = tuple(int(s) for s in cfg.get("strides", (1, 1)))
        dilation = tuple(int(d) for d in cfg.get("dilation_rate", (1, 1)))
        padding = _pool_padding(cfg)
        use_bias = cfg.get("use_bias", True)
        act = _activation(cfg.get("activation"))
        weights = {"kernel": ((kh, kw, cin, filters), _kernel_init(cfg))}
        self._bias(weights, cfg, (filters,))
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            y = _conv2d(x, p["kernel"].to(x.dtype), strides, padding, dilation)
            if use_bias:
                y = y + p["bias"].to(y.dtype)
            return act(y)

        self.fns.append(fn)
        self.shape = (_conv_dim(h, (kh - 1) * dilation[0] + 1, strides[0], padding),
                      _conv_dim(w, (kw - 1) * dilation[1] + 1, strides[1], padding), filters)

    def _add_DepthwiseConv2D(self, name: str, cfg: Dict[str, Any]) -> None:
        h, w, cin = self._need_shape(name)
        kh, kw = (int(d) for d in cfg["kernel_size"])
        mult = int(cfg.get("depth_multiplier", 1))
        strides = tuple(int(s) for s in cfg.get("strides", (1, 1)))
        dilation = tuple(int(d) for d in cfg.get("dilation_rate", (1, 1)))
        padding = _pool_padding(cfg)
        use_bias = cfg.get("use_bias", True)
        act = _activation(cfg.get("activation"))
        weights = {"depthwise_kernel": (
            (kh, kw, cin, mult),
            _initializer(cfg.get("depthwise_initializer") or cfg.get("kernel_initializer")
                         or {"class_name": "GlorotUniform"}))}
        self._bias(weights, cfg, (cin * mult,))
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            y = _depthwise(x, p["depthwise_kernel"], cin, mult, strides, padding, dilation)
            if use_bias:
                y = y + p["bias"].to(y.dtype)
            return act(y)

        self.fns.append(fn)
        self.shape = (_conv_dim(h, (kh - 1) * dilation[0] + 1, strides[0], padding),
                      _conv_dim(w, (kw - 1) * dilation[1] + 1, strides[1], padding), cin * mult)

    def _add_SeparableConv2D(self, name: str, cfg: Dict[str, Any]) -> None:
        """Depthwise conv, then a 1x1 pointwise conv; one bias, the
        activation after the pointwise step."""
        h, w, cin = self._need_shape(name)
        kh, kw = (int(d) for d in cfg["kernel_size"])
        mult = int(cfg.get("depth_multiplier", 1))
        filters = int(cfg["filters"])
        strides = tuple(int(s) for s in cfg.get("strides", (1, 1)))
        dilation = tuple(int(d) for d in cfg.get("dilation_rate", (1, 1)))
        padding = _pool_padding(cfg)
        use_bias = cfg.get("use_bias", True)
        act = _activation(cfg.get("activation"))
        weights = {
            "depthwise_kernel": ((kh, kw, cin, mult), _initializer(
                cfg.get("depthwise_initializer") or {"class_name": "GlorotUniform"})),
            "pointwise_kernel": ((1, 1, cin * mult, filters), _initializer(
                cfg.get("pointwise_initializer") or {"class_name": "GlorotUniform"})),
        }
        self._bias(weights, cfg, (filters,))
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            y = _depthwise(x, p["depthwise_kernel"], cin, mult, strides, padding, dilation)
            y = _conv2d(y, p["pointwise_kernel"].to(y.dtype), (1, 1), "VALID")
            if use_bias:
                y = y + p["bias"].to(y.dtype)
            return act(y)

        self.fns.append(fn)
        self.shape = (_conv_dim(h, (kh - 1) * dilation[0] + 1, strides[0], padding),
                      _conv_dim(w, (kw - 1) * dilation[1] + 1, strides[1], padding), filters)

    def _add_UpSampling2D(self, name: str, cfg: Dict[str, Any]) -> None:
        h, w, c = self._need_shape(name)
        size = cfg.get("size", (2, 2))
        sh, sw = (int(size), int(size)) if isinstance(size, int) else (int(size[0]),
                                                                       int(size[1]))
        interp = cfg.get("interpolation", "nearest")
        if interp != "nearest":
            raise ValueError(f"UpSampling2D {name!r}: only 'nearest' interpolation is "
                             f"supported, got {interp!r}")
        self.fns.append(lambda params, x: x.repeat_interleave(sh, 1).repeat_interleave(sw, 2))
        self.shape = (h * sh, w * sw, c)

    def _add_Conv2DTranspose(self, name: str, cfg: Dict[str, Any]) -> None:
        h, w, cin = self._need_shape(name)
        kh, kw = (int(d) for d in cfg["kernel_size"])
        filters = int(cfg["filters"])
        strides = tuple(int(s) for s in cfg.get("strides", (1, 1)))
        dl = cfg.get("dilation_rate", (1, 1))
        if tuple(int(d) for d in (dl if isinstance(dl, (list, tuple)) else (dl, dl))) != (1, 1):
            raise ValueError(f"Conv2DTranspose {name!r}: dilation_rate != 1 is not supported")
        if cfg.get("output_padding") is not None:
            raise ValueError(f"Conv2DTranspose {name!r}: output_padding is not supported")
        padding = _pool_padding(cfg)
        use_bias = cfg.get("use_bias", True)
        act = _activation(cfg.get("activation"))
        # Keras stores the transpose kernel as (kh, kw, OUT, IN)
        weights = {"kernel": ((kh, kw, filters, cin), _kernel_init(cfg))}
        self._bias(weights, cfg, (filters,))
        self._register(name, weights)
        # lax.conv_transpose's padding of the stride-dilated input on each
        # axis: SAME pads k + s - 2 in all, VALID k + s - 2 + max(k - s, 0)
        crops = []
        for k, s in ((kh, strides[0]), (kw, strides[1])):
            if padding == "SAME":
                total = k + s - 2
                lo = k - 1 if s > k - 1 else -(-total // 2)
            else:
                total, lo = k + s - 2 + max(k - s, 0), k - 1
            crops.append((k - 1 - lo, k - 1 - (total - lo)))

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            # the kernel (kh, kw, OUT, IN) permuted to (IN, OUT, kh, kw) is
            # conv_transpose2d's weight: the gradient of the conv whose
            # OIHW weight it is, as transpose_kernel=True computes (with
            # the spatial flip); the full output is then cut to JAX's pads
            k = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), k, stride=strides)
            for axis, (a, b) in zip((2, 3), crops):
                y = y.narrow(axis, a, y.shape[axis] - a - max(b, 0))
                if b < 0:  # padded past the kernel's reach: zero outputs
                    y = F.pad(y, (0, -b) if axis == 3 else (0, 0, 0, -b))
            y = y.permute(0, 2, 3, 1)
            if use_bias:
                y = y + p["bias"].to(y.dtype)
            return act(y)

        self.fns.append(fn)
        if padding == "SAME":
            oh, ow = h * strides[0], w * strides[1]
        else:  # VALID: Keras formula
            oh = h * strides[0] + max(kh - strides[0], 0)
            ow = w * strides[1] + max(kw - strides[1], 0)
        self.shape = (oh, ow, filters)

    def _add_LayerNormalization(self, name: str, cfg: Dict[str, Any]) -> None:
        shape = self._need_shape(name)
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            if len(axis) != 1:
                raise ValueError(f"LayerNormalization {name!r}: multi-axis normalization "
                                 "is not supported")
            axis = axis[0]
        full_rank = len(shape) + 1
        if axis % full_rank != full_rank - 1:
            raise ValueError(f"LayerNormalization {name!r}: only last-axis normalization "
                             f"is supported, got axis={axis}")
        c = shape[-1]
        eps = float(cfg.get("epsilon", 1e-3))
        scale = cfg.get("scale", True)
        center = cfg.get("center", True)
        weights = {}
        if scale:
            weights["gamma"] = ((c,), _initializer(cfg.get("gamma_initializer")
                                                   or {"class_name": "Ones"}))
        if center:
            weights["beta"] = ((c,), _initializer(cfg.get("beta_initializer")
                                                  or {"class_name": "Zeros"}))
        if weights:
            self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            xf = x.float()
            mean = xf.mean(dim=-1, keepdim=True)
            var = (xf - mean).square().mean(dim=-1, keepdim=True)
            y = (xf - mean) * torch.rsqrt(var + eps)
            if scale:
                y = y * params[name]["gamma"].float()
            if center:
                y = y + params[name]["beta"].float()
            return y.to(x.dtype)

        self.fns.append(fn)

    def _add_Dense(self, name: str, cfg: Dict[str, Any]) -> None:
        # Keras Dense applies along the LAST axis of any-rank input
        shape = self._need_shape(name)
        units = int(cfg["units"])
        weights = {"kernel": ((shape[-1], units), _kernel_init(cfg))}
        self._bias(weights, cfg, (units,))
        self._register(name, weights)
        self.fns.append(_dense_fn(name, cfg.get("use_bias", True),
                                  _activation(cfg.get("activation"))))
        self.shape = shape[:-1] + (units,)

    def _add_InputLayer(self, name: str, cfg: Dict[str, Any]) -> None:
        # identity; exists only to carry batch_input_shape (consumed in add())
        self.fns.append(lambda params, x: x)

    def _add_Embedding(self, name: str, cfg: Dict[str, Any]) -> None:
        shape = self._need_shape(name)
        if len(shape) != 1:
            raise ValueError(f"Embedding {name!r} expects [B, S] integer input, got "
                             f"feature shape {shape}")
        if cfg.get("mask_zero"):
            raise ValueError(
                f"Embedding {name!r} uses mask_zero=True; masking is not "
                "supported (downstream RNNs would silently run over padded "
                "timesteps instead of skipping them)")
        output_dim = int(cfg["output_dim"])
        self._register(name, {"embeddings": (
            (int(cfg["input_dim"]), output_dim),
            _initializer(cfg.get("embeddings_initializer") or {"class_name": "RandomUniform"}))})
        if not self._consumed_input:
            # the embedding consumes the raw model input (possibly through
            # identity InputLayers): tokens stay integer
            self.integer_input = True
        self.fns.append(lambda params, x: params[name]["embeddings"][x.long()])
        self.shape = shape + (output_dim,)

    def _add_Conv1D(self, name: str, cfg: Dict[str, Any]) -> None:
        s, c = self._need_shape(name)
        ks = cfg["kernel_size"]
        k = int(ks[0] if isinstance(ks, (list, tuple)) else ks)
        filters = int(cfg["filters"])
        st = cfg.get("strides", 1)
        stride = int(st[0] if isinstance(st, (list, tuple)) else st)
        dl = cfg.get("dilation_rate", 1)
        dilation = int(dl[0] if isinstance(dl, (list, tuple)) else dl)
        pad_mode = cfg.get("padding", "valid")
        if pad_mode not in ("valid", "same", "causal"):
            raise ValueError(f"Conv1D padding {pad_mode!r} unsupported")
        use_bias = cfg.get("use_bias", True)
        act = _activation(cfg.get("activation"))
        weights = {"kernel": ((k, c, filters), _kernel_init(cfg))}
        self._bias(weights, cfg, (filters,))
        self._register(name, weights)
        ek = (k - 1) * dilation + 1

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            if pad_mode == "causal":
                x = F.pad(x, (0, 0, ek - 1, 0))
            elif pad_mode == "same":
                x = F.pad(x, (0, 0) + _same_pad(x.shape[1], ek, stride))
            y = F.conv1d(x.permute(0, 2, 1), p["kernel"].to(x.dtype).permute(2, 1, 0),
                         stride=stride, dilation=dilation).permute(0, 2, 1)
            if use_bias:
                y = y + p["bias"].to(y.dtype)
            return act(y)

        self.fns.append(fn)
        if pad_mode == "causal":
            out_s = -(-s // stride)  # full length, left-padded
        else:
            out_s = _conv_dim(s, ek, stride, pad_mode.upper())
        self.shape = (out_s, filters)

    def _pool1d(self, name: str, cfg: Dict[str, Any], reducer: str) -> None:
        s, c = self._need_shape(name)
        ps = cfg.get("pool_size", 2)
        p_ = int(ps[0] if isinstance(ps, (list, tuple)) else ps)
        st = cfg.get("strides") or p_
        stride = int(st[0] if isinstance(st, (list, tuple)) else st)
        padding = _pool_padding(cfg)
        self.fns.append(lambda params, x: _window(x, (p_,), (stride,), padding, reducer))
        self.shape = (_conv_dim(s, p_, stride, padding), c)

    def _add_MaxPooling1D(self, name: str, cfg: Dict[str, Any]) -> None:
        self._pool1d(name, cfg, "max")

    def _add_AveragePooling1D(self, name: str, cfg: Dict[str, Any]) -> None:
        self._pool1d(name, cfg, "avg")

    def _add_GlobalAveragePooling1D(self, name: str, cfg: Dict[str, Any]) -> None:
        _, c = self._need_shape(name)
        self.fns.append(lambda params, x: x.mean(dim=1))
        self.shape = (c,)

    def _add_GlobalMaxPooling1D(self, name: str, cfg: Dict[str, Any]) -> None:
        _, c = self._need_shape(name)
        self.fns.append(lambda params, x: x.amax(dim=1))
        self.shape = (c,)

    def _add_GlobalMaxPooling2D(self, name: str, cfg: Dict[str, Any]) -> None:
        _, _, c = self._need_shape(name)
        self.fns.append(lambda params, x: x.amax(dim=(1, 2)))
        self.shape = (c,)

    def _add_SpatialDropout1D(self, name: str, cfg: Dict[str, Any]) -> None:
        self.fns.append(lambda params, x: x)  # inference mode, like Dropout

    # -- recurrent layers --------------------------------------------------

    def _rnn_common(self, name: str, cfg: Dict[str, Any]):
        """Shape bookkeeping shared by the RNNs: (in_features, units,
        use_bias, return_sequences)."""
        shape = self._need_shape(name)
        if len(shape) != 2:
            raise ValueError(f"{name!r} expects [B, S, C] input, got feature shape {shape}")
        if cfg.get("stateful") or cfg.get("go_backwards"):
            raise ValueError(f"{name!r}: stateful/go_backwards RNNs are not supported")
        s, c = shape
        units = int(cfg["units"])
        ret_seq = bool(cfg.get("return_sequences", False))
        self.shape = (s, units) if ret_seq else (units,)
        return c, units, cfg.get("use_bias", True), ret_seq

    def _add_Bidirectional(self, name: str, cfg: Dict[str, Any]) -> None:
        """Forward and time-reversed copies of the wrapped RNN, merged; the
        weights are keyed ``<bidi>/forward_<inner>`` and
        ``<bidi>/backward_<inner>``, as Keras/tfjs export them."""
        inner = cfg.get("layer")
        if not inner:
            raise ValueError(f"Bidirectional {name!r} has no wrapped layer")
        icls = inner["class_name"]
        if icls not in ("SimpleRNN", "LSTM", "GRU"):
            raise ValueError(f"Bidirectional wraps {icls!r}; only SimpleRNN/LSTM/GRU "
                             "are supported")
        merge = cfg.get("merge_mode", "concat")
        if merge not in ("concat", "sum", "ave", "mul"):
            raise ValueError(f"Bidirectional merge_mode {merge!r} unsupported")
        icfg = dict(inner.get("config", {}))
        inner_name = icfg.get("name", icls.lower())
        ret_seq = bool(icfg.get("return_sequences", False))
        in_shape = self._need_shape(name)
        handler = getattr(self, f"_add_{icls}")
        fns = {}
        for direction in ("forward", "backward"):
            sub = dict(icfg)
            sub["name"] = f"{name}/{direction}_{inner_name}"
            self.shape = in_shape  # both copies see the wrapper's input
            handler(sub["name"], sub)
            fns[direction] = self.fns.pop()  # the wrapper emits ONE fn
        out_shape = self.shape  # one direction's output shape
        fwd, bwd = fns["forward"], fns["backward"]

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            f = fwd(params, x)
            b = bwd(params, x.flip(1))
            if ret_seq:
                b = b.flip(1)  # re-align to forward time order
            if merge == "concat":
                return torch.cat([f, b], dim=-1)
            if merge == "sum":
                return f + b
            if merge == "ave":
                return (f + b) / 2.0
            return f * b  # mul

        self.fns.append(fn)
        self.shape = (out_shape[:-1] + (2 * out_shape[-1],)) if merge == "concat" else out_shape

    def _recurrent_init(self, cfg: Dict[str, Any]) -> Init:
        return _initializer(cfg.get("recurrent_initializer") or {"class_name": "Orthogonal"})

    def _add_SimpleRNN(self, name: str, cfg: Dict[str, Any]) -> None:
        c, units, use_bias, ret_seq = self._rnn_common(name, cfg)
        act = _activation(cfg.get("activation", "tanh"))
        weights = {"kernel": ((c, units), _kernel_init(cfg)),
                   "recurrent_kernel": ((units, units), self._recurrent_init(cfg))}
        self._bias(weights, cfg, (units,))
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            k, rk = p["kernel"].float(), p["recurrent_kernel"].float()
            b = p["bias"].float() if use_bias else 0.0

            def step(carry, xt):
                (h,) = carry
                h = act(xt.float() @ k + h @ rk + b)
                return (h,), h

            h0 = torch.zeros(x.shape[0], units, device=x.device)
            return _scan_rnn(step, (h0,), x, ret_seq).to(x.dtype)

        self.fns.append(fn)

    def _warn_rnn_default(self, name: str, cfg: Dict[str, Any], field: str,
                          tfjs_default: str, tfkeras_default: str) -> None:
        """Absent RNN config fields take the tfjs/legacy-Keras defaults
        (this importer's source format); tf.keras's differ, so say so."""
        if field not in cfg:
            warnings.warn(
                f"{name}: config omits {field!r}; using the tfjs/legacy-Keras "
                f"default {tfjs_default} (tf.keras would default to "
                f"{tfkeras_default}) — set the field explicitly to silence",
                stacklevel=3)

    def _add_LSTM(self, name: str, cfg: Dict[str, Any]) -> None:
        c, units, use_bias, ret_seq = self._rnn_common(name, cfg)
        act = _activation(cfg.get("activation", "tanh"))
        self._warn_rnn_default(name, cfg, "recurrent_activation", "'hard_sigmoid'", "'sigmoid'")
        rec_act = _activation(cfg.get("recurrent_activation", "hard_sigmoid"))
        bias_init = _initializer(cfg.get("bias_initializer"))
        if cfg.get("unit_forget_bias", True):
            base_init = bias_init

            def bias_init(gen, shape):  # noqa: F811
                # the configured initializer everywhere except the
                # forget-gate block, which gets ones
                b = base_init(gen, shape)
                b[units:2 * units] = 1.0
                return b
        weights = {"kernel": ((c, 4 * units), _kernel_init(cfg)),
                   "recurrent_kernel": ((units, 4 * units), self._recurrent_init(cfg))}
        if use_bias:
            weights["bias"] = ((4 * units,), bias_init)
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            k, rk = p["kernel"].float(), p["recurrent_kernel"].float()
            b = p["bias"].float() if use_bias else 0.0

            def step(carry, xt):
                h, cell = carry
                z = xt.float() @ k + h @ rk + b  # [B, 4U], gate order i|f|c|o
                i, f, g, o = z.split(units, dim=1)
                cell = rec_act(f) * cell + rec_act(i) * act(g)
                h = rec_act(o) * act(cell)
                return (h, cell), h

            h0 = torch.zeros(x.shape[0], units, device=x.device)
            return _scan_rnn(step, (h0, h0), x, ret_seq).to(x.dtype)

        self.fns.append(fn)

    def _add_GRU(self, name: str, cfg: Dict[str, Any]) -> None:
        c, units, use_bias, ret_seq = self._rnn_common(name, cfg)
        act = _activation(cfg.get("activation", "tanh"))
        self._warn_rnn_default(name, cfg, "recurrent_activation", "'hard_sigmoid'", "'sigmoid'")
        rec_act = _activation(cfg.get("recurrent_activation", "hard_sigmoid"))
        self._warn_rnn_default(name, cfg, "reset_after", "False", "True")
        reset_after = bool(cfg.get("reset_after", False))
        weights = {"kernel": ((c, 3 * units), _kernel_init(cfg)),
                   "recurrent_kernel": ((units, 3 * units), self._recurrent_init(cfg))}
        self._bias(weights, cfg, (2, 3 * units) if reset_after else (3 * units,))
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            k, rk = p["kernel"].float(), p["recurrent_kernel"].float()
            if use_bias:
                b = p["bias"].float()
                bi, br = (b[0], b[1]) if reset_after else (b, torch.zeros_like(b))
            else:
                bi = br = torch.zeros(3 * units, device=x.device)

            def step(carry, xt):
                (h,) = carry
                xz, xr, xh = (xt.float() @ k + bi).split(units, dim=-1)
                if reset_after:
                    hz, hr, hh = (h @ rk + br).split(units, dim=-1)
                    z = rec_act(xz + hz)
                    r = rec_act(xr + hr)
                    cand = act(xh + r * hh)
                else:
                    rz, rr, rh = rk.split(units, dim=1)
                    z = rec_act(xz + h @ rz)
                    r = rec_act(xr + h @ rr)
                    cand = act(xh + (r * h) @ rh)
                h = z * h + (1.0 - z) * cand  # Keras update convention
                return (h,), h

            h0 = torch.zeros(x.shape[0], units, device=x.device)
            return _scan_rnn(step, (h0,), x, ret_seq).to(x.dtype)

        self.fns.append(fn)

    # -- activations and structural layers ---------------------------------

    def _add_Activation(self, name: str, cfg: Dict[str, Any]) -> None:
        act = _activation(cfg.get("activation"))
        self.fns.append(lambda params, x: act(x))

    def _add_ReLU(self, name: str, cfg: Dict[str, Any]) -> None:
        max_value = cfg.get("max_value")
        slope = float(cfg.get("negative_slope") or 0.0)
        threshold = float(cfg.get("threshold") or 0.0)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            y = torch.where(x >= threshold, x, slope * (x - threshold))
            if max_value is not None:
                y = torch.clamp(y, max=max_value)
            return y

        self.fns.append(fn)

    def _add_ZeroPadding1D(self, name: str, cfg: Dict[str, Any]) -> None:
        t, c = self._need_shape(name)
        l, r = _pair(cfg.get("padding", 1))
        self.fns.append(lambda params, x: F.pad(x, (0, 0, l, r)))
        self.shape = (t + l + r, c)

    def _add_Cropping1D(self, name: str, cfg: Dict[str, Any]) -> None:
        t, c = self._need_shape(name)
        l, r = _pair(cfg.get("cropping", (1, 1)))
        if t - l - r <= 0:
            raise ValueError(f"{name}: cropping ({l}, {r}) exceeds input length {t}")
        self.fns.append(lambda params, x: x[:, l:x.shape[1] - r, :])
        self.shape = (t - l - r, c)

    def _add_Cropping2D(self, name: str, cfg: Dict[str, Any]) -> None:
        h, w, c = self._need_shape(name)
        crop = cfg.get("cropping", ((0, 0), (0, 0)))
        if isinstance(crop, int):
            crop = ((crop, crop), (crop, crop))
        (t, b), (l, r) = (
            (crop[0], crop[0]) if isinstance(crop[0], int) else tuple(crop[0]),
            (crop[1], crop[1]) if isinstance(crop[1], int) else tuple(crop[1]))
        t, b, l, r = int(t), int(b), int(l), int(r)
        if h - t - b <= 0 or w - l - r <= 0:
            raise ValueError(f"{name}: cropping {crop} exceeds input {h}x{w}")
        self.fns.append(lambda params, x: x[:, t:x.shape[1] - b, l:x.shape[2] - r, :])
        self.shape = (h - t - b, w - l - r, c)

    def _add_Permute(self, name: str, cfg: Dict[str, Any]) -> None:
        dims = tuple(int(d) for d in cfg["dims"])  # 1-based, batch excluded
        shape = self._need_shape(name)
        if sorted(dims) != list(range(1, len(shape) + 1)):
            raise ValueError(f"{name}: dims {dims} not a permutation of input rank")
        self.fns.append(lambda params, x: x.permute((0,) + dims))
        self.shape = tuple(shape[d - 1] for d in dims)

    def _add_RepeatVector(self, name: str, cfg: Dict[str, Any]) -> None:
        (c,) = self._need_shape(name)  # requires a [B, C] input
        n = int(cfg["n"])
        self.fns.append(lambda params, x: x[:, None, :].repeat(1, n, 1))
        self.shape = (n, c)

    def _add_TimeDistributed(self, name: str, cfg: Dict[str, Any]) -> None:
        """Unwrap to the inner layer: every supported inner op broadcasts
        over the leading dims, so applying it per time step IS applying it
        to the [B, T, ...] tensor."""
        inner = cfg.get("layer")
        if not inner:
            raise ValueError(f"{name}: TimeDistributed without an inner layer")
        if len(self._need_shape(name)) < 2:
            raise ValueError(
                f"{name}: TimeDistributed needs a time dimension "
                f"(input feature shape {self._need_shape(name)} is rank "
                f"{len(self._need_shape(name))}; Keras requires >= 3D tensors)")
        # weights register under the WRAPPER's name, as Keras/tfjs export
        # the inner variables ('time_distributed/kernel')
        icfg = {**dict(inner.get("config", {})), "name": name}
        inner_cls = inner["class_name"]
        if inner_cls not in ("Dense", "Activation", "Dropout", "LeakyReLU",
                             "ELU", "Softmax", "Flatten"):
            raise ValueError(f"{name}: TimeDistributed({inner_cls}) is not supported — "
                             "only per-feature inner layers broadcast over time here")
        if inner_cls == "Flatten":
            # per-step flatten: [B, T, ...] -> [B, T, prod(rest)]
            shape = self._need_shape(name)
            self.fns.append(lambda params, x: x.reshape(x.shape[0], x.shape[1], -1))
            self.shape = (shape[0], int(np.prod(shape[1:])))
            return
        # straight to the inner handler (add() appends this layer's name)
        getattr(self, f"_add_{inner_cls}")(name, icfg)

    def _add_LeakyReLU(self, name: str, cfg: Dict[str, Any]) -> None:
        # Keras 2/tfjs serialize 'alpha'; Keras 3 'negative_slope'
        alpha = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))
        self.fns.append(lambda params, x: torch.where(x >= 0, x, alpha * x))

    def _add_ELU(self, name: str, cfg: Dict[str, Any]) -> None:
        alpha = float(cfg.get("alpha", 1.0))
        self.fns.append(lambda params, x: F.elu(x, alpha=alpha))

    def _add_Softmax(self, name: str, cfg: Dict[str, Any]) -> None:
        axis = cfg.get("axis", -1)
        axis = axis[0] if isinstance(axis, (list, tuple)) and len(axis) == 1 else axis
        self.fns.append(lambda params, x: torch.softmax(x, dim=axis))

    def _add_PReLU(self, name: str, cfg: Dict[str, Any]) -> None:
        """A learnable leaky slope, one per feature, with ``shared_axes``
        (1-based, batch excluded) collapsed to 1."""
        shape = self._need_shape(name)
        shared = cfg.get("shared_axes") or ()
        alpha_shape = tuple(1 if (i + 1) in shared else d for i, d in enumerate(shape))
        self._register(name, {"alpha": (alpha_shape, _initializer(
            cfg.get("alpha_initializer") or {"class_name": "Zeros"}))})

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            return torch.where(x >= 0, x, params[name]["alpha"].to(x.dtype) * x)

        self.fns.append(fn)

    def _add_ZeroPadding2D(self, name: str, cfg: Dict[str, Any]) -> None:
        h, w, c = self._need_shape(name)
        pad = cfg.get("padding", 1)
        if isinstance(pad, int):
            pad = ((pad, pad), (pad, pad))
        elif isinstance(pad[0], int):
            pad = ((pad[0], pad[0]), (pad[1], pad[1]))
        (pt, pb), (pl, pr) = ((int(a), int(b)) for a, b in pad)
        self.fns.append(lambda params, x: F.pad(x, (0, 0, pl, pr, pt, pb)))
        self.shape = (h + pt + pb, w + pl + pr, c)

    def _pool(self, name: str, cfg: Dict[str, Any], reducer: str) -> None:
        h, w, c = self._need_shape(name)
        ph, pw = (int(d) for d in cfg.get("pool_size", (2, 2)))
        strides = cfg.get("strides") or (ph, pw)
        sh, sw = (int(s) for s in strides)
        padding = _pool_padding(cfg)
        self.fns.append(lambda params, x: _window(x, (ph, pw), (sh, sw), padding, reducer))
        self.shape = (_conv_dim(h, ph, sh, padding), _conv_dim(w, pw, sw, padding), c)

    def _add_MaxPooling2D(self, name: str, cfg: Dict[str, Any]) -> None:
        self._pool(name, cfg, "max")

    def _add_AveragePooling2D(self, name: str, cfg: Dict[str, Any]) -> None:
        self._pool(name, cfg, "avg")

    def _add_GlobalAveragePooling2D(self, name: str, cfg: Dict[str, Any]) -> None:
        _, _, c = self._need_shape(name)
        self.fns.append(lambda params, x: x.mean(dim=(1, 2)))
        self.shape = (c,)

    def _add_Flatten(self, name: str, cfg: Dict[str, Any]) -> None:
        shape = self._need_shape(name)
        self.fns.append(lambda params, x: x.reshape(x.shape[0], -1))
        self.shape = (int(np.prod(shape)),)

    def _add_Reshape(self, name: str, cfg: Dict[str, Any]) -> None:
        target = tuple(int(d) for d in cfg["target_shape"])
        if target.count(-1) > 1:
            raise ValueError(f"{name}: target_shape {target} has more than one -1")
        if -1 in target:
            # resolve the wildcard now, so later fan-ins are concrete
            known = int(np.prod(self._need_shape(name)))
            rest = int(np.prod([d for d in target if d != -1]))
            if rest <= 0 or known % rest:
                raise ValueError(f"{name}: cannot infer -1 in target_shape {target} from "
                                 f"{known} elements")
            target = tuple(known // rest if d == -1 else d for d in target)
        self.fns.append(lambda params, x: x.reshape((x.shape[0],) + target))
        self.shape = target

    def _add_Dropout(self, name: str, cfg: Dict[str, Any]) -> None:
        # identity: the reference's fit path runs layers in inference mode
        self.fns.append(lambda params, x: x)

    def _add_BatchNormalization(self, name: str, cfg: Dict[str, Any]) -> None:
        c = self._need_shape(name)[-1]
        eps = float(cfg.get("epsilon", 1e-3))
        scale = cfg.get("scale", True)
        center = cfg.get("center", True)
        weights = {"moving_mean": ((c,), _constant(0.0)),
                   "moving_variance": ((c,), _constant(1.0))}
        if scale:
            weights["gamma"] = ((c,), _initializer(cfg.get("gamma_initializer")
                                                   or {"class_name": "Ones"}))
        if center:
            weights["beta"] = ((c,), _initializer(cfg.get("beta_initializer")
                                                  or {"class_name": "Zeros"}))
        self._register(name, weights)

        def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
            p = params[name]
            inv = torch.rsqrt(p["moving_variance"].to(x.dtype) + eps)
            y = (x - p["moving_mean"].to(x.dtype)) * inv
            if scale:
                y = y * p["gamma"].to(x.dtype)
            if center:
                y = y + p["beta"].to(x.dtype)
            return y

        self.fns.append(fn)


def _dense_fn(name: str, use_bias: bool,
              act: Callable[[torch.Tensor], torch.Tensor] = lambda x: x) -> LayerFn:
    """The one Dense lowering, shared by the layer handler and both
    softmax-strip rewrites (the same matmul minus the activation)."""

    def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
        p = params[name]
        y = x @ p["kernel"].to(x.dtype)
        if use_bias:
            y = y + p["bias"].to(y.dtype)
        return act(y)

    return fn


def _model_config(topology: Dict[str, Any]) -> Tuple[str, Any]:
    """Classify the json into ('Sequential', layer_list) or ('Functional',
    graph_config), across the shapes tfjs and Keras emit."""
    mt = topology.get("modelTopology", topology)
    mc = mt.get("model_config", mt)
    cls = mc.get("class_name")
    if cls is None and "layers" in mc:
        return "Sequential", mc["layers"]
    if cls == "Sequential":
        cfg = mc["config"]
        return "Sequential", (cfg if isinstance(cfg, list) else cfg["layers"])
    if cls in ("Model", "Functional"):
        return "Functional", mc["config"]
    raise ValueError(f"unsupported model_config class_name={cls!r} (expected Sequential, "
                     "Model, or Functional)")


# -- graph (Functional) topologies ----------------------------------------

_MERGE_LAYERS = ("Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum", "Concatenate")


def _fold(op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
          ) -> Callable[[Params, List[torch.Tensor]], torch.Tensor]:
    def fn(params: Params, xs: List[torch.Tensor]) -> torch.Tensor:
        y = xs[0]
        for x in xs[1:]:
            y = op(y, x)
        return y

    return fn


def _merge_lowering(class_name: str, cfg: Dict[str, Any], in_shapes: List[Tuple[int, ...]]
                    ) -> Tuple[Callable[[Params, List[torch.Tensor]], torch.Tensor],
                               Tuple[int, ...]]:
    """Lower a parameterless merge layer: (fn(params, xs) -> y, out_shape)."""
    if class_name == "Concatenate":
        full_rank = len(in_shapes[0]) + 1  # + batch dim
        axis = int(cfg.get("axis", -1)) % full_rank
        if axis == 0:
            raise ValueError("Concatenate over the batch axis is not supported")
        fi = axis - 1  # feature-shape index
        base = list(in_shapes[0])
        for s in in_shapes[1:]:
            if len(s) != len(base) or any(a != b for i, (a, b) in enumerate(zip(s, base))
                                          if i != fi):
                raise ValueError(f"Concatenate inputs disagree off-axis: {in_shapes}")
        base[fi] = sum(s[fi] for s in in_shapes)
        return (lambda params, xs: torch.cat(list(xs), dim=axis)), tuple(base)
    if any(s != in_shapes[0] for s in in_shapes[1:]):
        raise ValueError(f"{class_name} inputs must agree in shape: {in_shapes}")
    if class_name == "Subtract":
        if len(in_shapes) != 2:
            raise ValueError("Subtract takes exactly two inputs")
        return (lambda params, xs: xs[0] - xs[1]), in_shapes[0]
    if class_name == "Average":
        add = _fold(torch.add)
        return (lambda params, xs: add(params, xs) / len(xs)), in_shapes[0]
    op = {"Add": torch.add, "Multiply": torch.mul, "Maximum": torch.maximum,
          "Minimum": torch.minimum}[class_name]
    return _fold(op), in_shapes[0]


GraphStep = Tuple[str, List[str], Callable[[Params, List[torch.Tensor]], torch.Tensor]]

# layer classes that consume raw integer ids: a model input feeding one of
# these is not float-cast by apply()
_INTEGER_INPUT_LAYERS = ("Embedding",)


def _node_key(name: str, node_idx: int) -> str:
    """Env key of one layer invocation (``name@node``)."""
    return f"{name}@{node_idx}"


def _ref_key(ref: Any, where: str) -> str:
    """(layer_name, node_index, tensor_index[, kwargs]) ref -> env key."""
    if not isinstance(ref, (list, tuple)) or not ref or not isinstance(ref[0], str):
        raise ValueError(f"unrecognized tensor reference in {where}: {ref!r}")
    if len(ref) > 2 and int(ref[2]) != 0:
        raise ValueError(f"{where}: tensor_index {ref[2]} != 0 — multi-tensor layer "
                         "outputs (e.g. return_state) are not supported")
    return _node_key(ref[0], int(ref[1]) if len(ref) > 1 else 0)


def _build_graph(gconfig: Dict[str, Any], builder: _Builder, input_shape: Optional[Sequence]
                 ) -> Tuple[List[GraphStep], List[str], List[str],
                            List[Tuple[int, ...]], List[Tuple[int, ...]], List[str]]:
    """Lower a Functional layer DAG (multi-input, multi-output, shared
    layers). Every (layer, call-node) pair lowers to one step; a layer
    called at several nodes registers its weights once. Returns ``(steps
    in topological order, input keys, output keys, input feature shapes,
    output feature shapes, integer input keys)``."""
    layers = gconfig["layers"]
    builder.allow_shared = True
    input_refs = list(gconfig.get("input_layers", ()))
    output_refs = list(gconfig.get("output_layers", ()))
    if not input_refs or not output_refs:
        raise ValueError("Functional graph missing input_layers/output_layers")
    input_keys = [_ref_key(r, "input_layers") for r in input_refs]
    output_keys = [_ref_key(r, "output_layers") for r in output_refs]

    if input_shape is not None and len(input_keys) > 1:
        if len(input_shape) != len(input_keys) or not all(
                isinstance(s, (tuple, list)) for s in input_shape):
            raise ValueError(
                f"model has {len(input_keys)} inputs; input_shape must be a "
                f"sequence of {len(input_keys)} shapes, got {input_shape!r}")
        given = {k: tuple(int(d) for d in s) for k, s in zip(input_keys, input_shape)}
    elif input_shape is not None:
        given = {input_keys[0]: tuple(int(d) for d in input_shape)}
    else:
        given = {}

    shapes: Dict[str, Tuple[int, ...]] = {}
    steps: List[GraphStep] = []
    integer_inputs: List[str] = []
    pending: List[Tuple[Dict[str, Any], int, List[str]]] = []

    for layer in layers:
        name = layer["name"]
        nodes = layer.get("inbound_nodes", [])
        if layer["class_name"] == "InputLayer" or not nodes:
            key = _node_key(name, 0)
            if key not in input_keys:
                raise ValueError(f"layer {name!r} has no inbound nodes but is not a "
                                 "declared input layer")
            shape = dict(layer.get("config", {})).get("batch_input_shape")
            shape = _feature_shape(shape, name) if shape else given.get(key)
            if shape is None:
                raise ValueError(f"input layer {name!r} has no batch_input_shape; "
                                 "pass input_shape=")
            shapes[key] = tuple(shape)
            continue
        for j, node in enumerate(nodes):
            parents = [_ref_key(p, f"layer {name!r} node {j}") for p in node]
            pending.append((layer, j, parents))

    while pending:
        progressed = False
        for item in list(pending):
            layer, j, parents = item
            if not all(p in shapes for p in parents):
                continue  # parents not lowered yet
            name, cls = layer["name"], layer["class_name"]
            cfg = dict(layer.get("config", {}))
            cfg.setdefault("name", name)  # the graph name IS the param key
            key = _node_key(name, j)
            in_shapes = [shapes[p] for p in parents]
            if cls in _MERGE_LAYERS:
                fn, out_shape = _merge_lowering(cls, cfg, in_shapes)
                steps.append((key, parents, fn))
            else:
                builder.shape = in_shapes[0]
                builder.add(cls, cfg)  # registers params once per layer name
                single = builder.fns[-1]
                steps.append((key, parents, lambda params, xs, f=single: f(params, xs[0])))
                out_shape = builder.shape
                if cls in _INTEGER_INPUT_LAYERS:
                    integer_inputs.extend(p for p in parents if p in input_keys)
            shapes[key] = tuple(out_shape)
            pending.remove(item)
            progressed = True
        if pending and not progressed:
            unresolved = sorted(_node_key(l["name"], j) for l, j, _ in pending)
            raise ValueError(f"graph has a cycle or dangling inputs; unresolved: {unresolved}")
    missing = [k for k in input_keys + output_keys if k not in shapes]
    if missing:
        raise ValueError(f"input/output tensors not in graph: {missing}")
    return (steps, input_keys, output_keys, [shapes[k] for k in input_keys],
            [shapes[k] for k in output_keys], integer_inputs)


def _strip_graph_softmax(layers: List[Dict[str, Any]], steps: List[GraphStep], out_key: str,
                         out_shape: Optional[Tuple[int, ...]] = None) -> bool:
    """Graph-mode :func:`_strip_trailing_softmax`: rewrite the output
    node's fn if it ends in softmax. Returns True if stripped."""
    out_name = out_key.rsplit("@", 1)[0]
    layer = next(l for l in layers if l["name"] == out_name)
    cfg = layer.get("config", {})
    idx = next(i for i, (n, _, _) in enumerate(steps) if n == out_key)
    key, parents, _ = steps[idx]
    if ((layer["class_name"] == "Activation" and cfg.get("activation") == "softmax")
            or (layer["class_name"] == "Softmax"
                and _is_last_axis(cfg.get("axis", -1), out_shape))):
        steps[idx] = (key, parents, lambda params, xs: xs[0])
        return True
    if layer["class_name"] == "Dense" and cfg.get("activation") == "softmax":
        f = _dense_fn(out_name, cfg.get("use_bias", True))
        steps[idx] = (key, parents, lambda params, xs: f(params, xs[0]))
        return True
    return False


# -- weights ----------------------------------------------------------------


def load_keras_weights(model_json_path: str, manifest: List[Dict[str, Any]]
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a tfjs ``weightsManifest``: the binary shard files sit next to
    model.json; each group's shards concatenate (in manifest order) into
    one little-endian buffer carrying the group's weights back to back."""
    base = os.path.dirname(os.path.abspath(model_json_path))
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for group in manifest:
        parts = []
        for p in group["paths"]:
            with open(os.path.join(base, p), "rb") as f:
                parts.append(f.read())
        buf = b"".join(parts)
        offset = 0
        for w in group["weights"]:
            if "quantization" in w:
                raise ValueError(
                    f"weight {w['name']!r} is quantized (tfjs --quantize_* "
                    "export); quantized manifests are not supported — "
                    "re-export without quantization")
            dtype_name = w.get("dtype", "float32")
            if dtype_name not in _DTYPES:
                raise ValueError(f"weight {w['name']!r} has unsupported dtype "
                                 f"{dtype_name!r}; supported: {sorted(_DTYPES)}")
            shape = tuple(int(d) for d in w["shape"])
            count = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(buf, dtype=_DTYPES[dtype_name], count=count, offset=offset)
            offset += arr.nbytes
            layer, _, wname = w["name"].rpartition("/")
            params.setdefault(layer, {})[wname] = arr.reshape(shape)
        if offset != len(buf):
            raise ValueError(f"weight group {group['paths']}: manifest describes {offset} "
                             f"bytes but shards hold {len(buf)}")
    return params


def _load_h5_weights(mw: Any) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a Keras ``model_weights`` HDF5 group into a ``{layer: {weight}}``
    tree: weight names look like ``dense_1/kernel:0`` (possibly one scope
    deeper); the enclosing group is the layer, except the ``forward_``/
    ``backward_`` scopes of a Bidirectional wrapper, which key
    ``<layer>/<scope>``; the leaf drops its ``:N`` suffix."""
    params: Dict[str, Dict[str, np.ndarray]] = {}

    def _names(attrs, key):
        return [n.decode("utf-8") if isinstance(n, bytes) else str(n)
                for n in attrs.get(key, [])]

    for lname in _names(mw.attrs, "layer_names"):
        group = mw[lname]
        for wpath in _names(group.attrs, "weight_names"):
            arr = np.asarray(group[wpath])
            leaf = wpath.rpartition("/")[2].split(":")[0]
            key = lname
            for seg in wpath.split("/")[:2]:  # the scope may or may not repeat lname
                if seg == lname:
                    continue  # the layer's own name, even if 'forward_*'
                if seg.startswith(("forward_", "backward_")):
                    key = f"{lname}/{seg}"
                break  # only the segment right after the (optional) lname
            params.setdefault(key, {})[leaf] = arr
    return params


def _check_loaded(loaded: Dict[str, Dict[str, Any]], inits: Dict[str, Any]) -> None:
    missing = [f"{l}/{w}" for l, ws in inits.items() for w in ws if w not in loaded.get(l, {})]
    if missing:
        raise ValueError("weightsManifest is missing parameters the topology declares: "
                         f"{missing[:8]}{'...' if len(missing) > 8 else ''}")
    for lname, ws in inits.items():
        for wname, (shape, _) in ws.items():
            got = tuple(loaded[lname][wname].shape)
            if got != tuple(shape):
                raise ValueError(f"{lname}/{wname}: manifest shape {got} != topology shape "
                                 f"{tuple(shape)}")


# -- the model and its spec --------------------------------------------------


def _escape(layer: str) -> str:
    """A Keras layer name as a module name (no ``.``), invertibly."""
    return layer.replace("%", "%25").replace(".", "%2E")


def _unescape(name: str) -> str:
    return name.replace("%2E", ".").replace("%25", "%")


def split_name(name: str) -> Tuple[str, str]:
    """A parameter name ``<layer>.<weight>`` -> ``(layer, weight)``."""
    layer, _, weight = name.rpartition(".")
    return _unescape(layer), weight


class KerasModel(nn.Module):
    """A Keras model's weights: one child module a layer (named by the
    layer, ``.`` escaped), each weight an f32 parameter under its Keras
    name (``conv2d_1.kernel``, ``bidi/forward_lstm.recurrent_kernel``)."""

    def __init__(self, tree: Dict[str, Dict[str, Any]]):
        super().__init__()
        for lname in sorted(tree):
            holder = nn.Module()
            for wname in sorted(tree[lname]):
                t = torch.as_tensor(np.array(tree[lname][wname], dtype=np.float32))
                holder.register_parameter(wname, nn.Parameter(t))
            self.add_module(_escape(lname), holder)

    def tree(self, dtype: Optional[torch.dtype] = None) -> Params:
        """``{layer: {weight: tensor}}``, each cast to ``dtype`` (autograd
        flows back to the f32 masters)."""
        out: Params = {}
        for name, p in self.named_parameters():
            layer, weight = split_name(name)
            out.setdefault(layer, {})[weight] = p if dtype is None else p.to(dtype)
        return out


def keras_tree_to_params(tree: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """A ``{layer: {weight: array}}`` tree (JAX's Keras params, or one read
    off the wire) -> ``{port name: array}``, the arrays as they are."""
    return {f"{_escape(l)}.{w}": v for l, ws in tree.items() for w, v in ws.items()}


def _to_wire(dtype: torch.dtype) -> Callable[[Dict[str, torch.Tensor]], Any]:
    from distriflow_tpu_torch.utils.serialization import to_numpy

    def to_wire(params: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
        """JAX's Keras tree, every leaf in the spec's dtype (JAX holds its
        Keras params in it, so its gradients and downloads come in it)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, v in params.items():
            layer, weight = split_name(name)
            out.setdefault(layer, {})[weight] = to_numpy(
                torch.as_tensor(v).detach().to(dtype))
        return out

    return to_wire


def _spec_from_topology(topology: Dict[str, Any], name: str,
                        loaded: Optional[Dict[str, Dict[str, np.ndarray]]],
                        input_shape: Optional[Sequence[int]], loss: str, logits_output: bool,
                        dtype: Any, device: Device) -> ModelSpec:
    """Lower a parsed topology (and optionally loaded weights) to a
    ModelSpec; both file formats funnel here."""
    from distriflow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    kind, config = _model_config(topology)
    builder = _Builder()
    if input_shape is not None and kind == "Sequential":
        input_shape = tuple(int(d) for d in input_shape)

    if kind == "Sequential":
        layers = config
        if input_shape is not None:
            builder.shape = input_shape
        for layer in layers:
            builder.add(layer["class_name"], dict(layer.get("config", {})))
        if builder.shape is None:
            raise ValueError("could not infer model shapes: no batch_input_shape anywhere")
        in_shape = input_shape if input_shape is not None else _input_shape_from(layers)
        out_shape = tuple(builder.shape)
        fns = list(builder.fns)
        stripped = bool(logits_output and fns
                        and _strip_trailing_softmax(layers, fns, builder.names, out_shape))
        multi_in = False
        float_mask: List[bool] = []

        def run(params: Params, y: torch.Tensor) -> torch.Tensor:
            for fn in fns:
                y = fn(params, y)
            return y

    else:  # Functional DAG
        (steps, in_keys, out_keys, in_shapes, out_shapes,
         integer_keys) = _build_graph(config, builder, input_shape)
        stripped = False
        if logits_output and steps:
            # strip every output head's trailing softmax, except heads some
            # other node also consumes
            consumed = {p for _, parents, _ in steps for p in parents}
            stripped = any([_strip_graph_softmax(config["layers"], steps, k, shp)
                            for k, shp in zip(out_keys, out_shapes) if k not in consumed])
        multi_in, multi_out = len(in_keys) > 1, len(out_keys) > 1
        in_shape = tuple(in_shapes) if multi_in else in_shapes[0]
        out_shape = tuple(out_shapes) if multi_out else out_shapes[0]
        if integer_keys:
            builder.integer_input = not multi_in or set(in_keys) <= set(integer_keys)
        float_mask = [k not in integer_keys for k in in_keys]

        def run(params: Params, y: Any) -> Any:
            if multi_in:
                if not isinstance(y, (tuple, list)) or len(y) != len(in_keys):
                    raise ValueError(f"model takes {len(in_keys)} inputs ({in_keys}); "
                                     f"got {type(y).__name__}")
                env = dict(zip(in_keys, y))
            else:
                env = {in_keys[0]: y}
            for sname, parents, fn in steps:
                env[sname] = fn(params, [env[p] for p in parents])
            if multi_out:
                return tuple(env[k] for k in out_keys)
            return env[out_keys[0]]

    inits = builder.inits
    if loaded is not None:
        _check_loaded(loaded, inits)

    def init(seed: int = 0) -> KerasModel:
        if loaded is not None:
            return KerasModel(loaded).to(dev)
        gen = torch.Generator().manual_seed(int(seed))
        tree = {lname: {wname: initf(gen, shape) for wname, (shape, initf)
                        in sorted(weights.items())}
                for lname, weights in sorted(inits.items())}
        return KerasModel(tree).to(dev)

    integer_input = builder.integer_input

    def apply(model: KerasModel, x: Any) -> Any:
        # Embedding-fed inputs take raw token ids; multi-input models cast
        # per input
        params = model.tree(dtype)
        if multi_in:
            if not isinstance(x, (tuple, list)) or len(x) != len(float_mask):
                raise ValueError(f"model takes {len(float_mask)} inputs; pass a "
                                 f"{len(float_mask)}-tuple of arrays, got {type(x).__name__}")
            xs = tuple(torch.as_tensor(xi, device=dev) for xi in x)
            return run(params, tuple(xi.to(dtype) if fm else xi
                                     for xi, fm in zip(xs, float_mask)))
        return run(params, x if integer_input else x.to(dtype))

    spec = ModelSpec(
        init=init, apply=apply, loss=loss, input_shape=tuple(in_shape),
        output_shape=tuple(out_shape),
        name=f"keras:{name}" + (":logits" if stripped else ""),
        device=dev, dtype=dtype, to_wire=_to_wire(dtype), from_wire=keras_tree_to_params)
    spec.check_loss()
    return spec


def spec_from_keras_json(path: str, input_shape: Optional[Sequence[int]] = None,
                         loss: str = "softmax_cross_entropy", logits_output: bool = True,
                         load_weights: bool = True, dtype: Any = torch.float32,
                         device: Device = None) -> ModelSpec:
    """Parse a tfjs-layers / Keras ``model.json`` into a :class:`ModelSpec`
    on ``device`` (``cuda`` by default).

    If the file carries a ``weightsManifest`` and the shard files exist
    next to it (and ``load_weights``), ``init`` returns the trained
    weights; a manifest whose shards are missing warns and cold-inits from
    each layer's recorded initializer. ``logits_output=True`` strips one
    trailing softmax (noted in the spec name)."""
    with open(path) as f:
        topology = json.load(f)
    loaded = None
    manifest = topology.get("weightsManifest")
    if load_weights and manifest:
        try:
            loaded = load_keras_weights(path, manifest)
        except FileNotFoundError as e:
            # a topology-only export (fine to cold-init) or a deployment
            # typo (not fine): say so loudly
            warnings.warn(
                f"{path!r} has a weightsManifest but a shard file is missing "
                f"({e.filename or e}); initializing UNTRAINED weights from "
                "the recorded layer initializers. Pass load_weights=False if "
                "cold init is intended.", stacklevel=2)
    return _spec_from_topology(topology, os.path.splitext(os.path.basename(path))[0], loaded,
                               input_shape, loss, logits_output, dtype, device)


def spec_from_keras_h5(path: str, input_shape: Optional[Sequence[int]] = None,
                       loss: str = "softmax_cross_entropy", logits_output: bool = True,
                       load_weights: bool = True, dtype: Any = torch.float32,
                       device: Device = None) -> ModelSpec:
    """Parse a Keras HDF5 (``.h5``) model file (``model.save('m.h5')``: the
    topology in the ``model_config`` attribute, the weights under
    ``model_weights``) into a :class:`ModelSpec`. Needs ``h5py``, imported
    here, so the port imports without it."""
    import h5py

    with h5py.File(path, "r") as f:
        cfg = f.attrs.get("model_config")
        if cfg is None:
            raise ValueError(
                f"{path!r} has no model_config attribute — not a Keras "
                "model file (weights-only .h5 files need the architecture; "
                "save with model.save, not save_weights)")
        if isinstance(cfg, bytes):
            cfg = cfg.decode("utf-8")
        topology = {"modelTopology": {"model_config": json.loads(cfg)}}
        loaded = None
        if load_weights and "model_weights" in f:
            mw = f["model_weights"]
            # an empty group (architecture-only save) means cold init
            loaded = _load_h5_weights(mw) or None
            if loaded is None and len(mw) > 0:
                raise ValueError(
                    f"{path!r}: model_weights contains {len(mw)} entries but "
                    "none parsed via the Keras layer_names/weight_names "
                    "layout; unsupported exporter — pass load_weights=False "
                    "to cold-init explicitly")
    return _spec_from_topology(topology, os.path.splitext(os.path.basename(path))[0], loaded,
                               input_shape, loss, logits_output, dtype, device)


def spec_from_url(url: str, input_shape: Optional[Sequence[int]] = None,
                  loss: str = "softmax_cross_entropy", logits_output: bool = True,
                  load_weights: bool = True, dtype: Any = torch.float32,
                  timeout: float = 30.0, device: Device = None) -> ModelSpec:
    """Load a tfjs-layers ``model.json`` (or Keras ``.h5``) over HTTP(S),
    the reference's string-URL model source: the topology downloads into
    a temp dir, each shard resolves relative to the model.json URL
    (``urljoin``) and downloads next to it, and the local loaders run
    (weights are read eagerly, so nothing outlives the temp dir). Every
    fetch error raises, a failed shard fetch too (the reference rejects
    it); a shard path that escapes the model directory raises."""
    import tempfile
    import urllib.error
    import urllib.parse
    import urllib.request

    if urllib.parse.urlparse(url).scheme not in ("http", "https"):
        raise ValueError(f"model URL must be http(s), got {url!r}")

    def _get(u: str) -> bytes:
        with urllib.request.urlopen(u, timeout=timeout) as resp:
            return resp.read()

    spec_kw = dict(input_shape=input_shape, loss=loss, logits_output=logits_output,
                   dtype=dtype, device=device)
    with tempfile.TemporaryDirectory(prefix="distriflow_url_model_") as tmp:
        if url.endswith((".h5", ".hdf5")):
            local = os.path.join(tmp, os.path.basename(urllib.parse.urlparse(url).path)
                                 or "model.h5")
            with open(local, "wb") as f:
                f.write(_get(url))  # errors raise: .h5 embeds its weights
            return spec_from_keras_h5(local, load_weights=load_weights, **spec_kw)

        body = _get(url)
        try:
            topology = json.loads(body)
        except json.JSONDecodeError as e:
            raise ValueError(f"{url!r} is not a model.json: {e}") from None
        local = os.path.join(tmp, "model.json")
        with open(local, "wb") as f:
            f.write(body)
        if load_weights:
            for group in topology.get("weightsManifest") or []:
                for p in group.get("paths", []):
                    # shard paths come from the remote manifest: confine
                    # them to the temp dir (no absolute / '..' escapes)
                    rel = os.path.normpath(p)
                    if os.path.isabs(rel) or rel.split(os.sep)[0] == "..":
                        raise ValueError(f"manifest shard path {p!r} escapes the model "
                                         "directory")
                    shard_url = urllib.parse.urljoin(url, p)
                    try:
                        shard = _get(shard_url)
                    except (urllib.error.URLError, OSError) as e:
                        raise OSError(
                            f"{url!r} names weight shard {shard_url!r} but "
                            f"fetching it failed ({e}). The reference "
                            "rejects on a failed shard fetch "
                            "(tf.loadLayersModel); pass load_weights=False "
                            "to cold-init from the recorded layer "
                            "initializers instead.") from e
                    dst = os.path.join(tmp, rel)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    with open(dst, "wb") as f:
                        f.write(shard)
        return spec_from_keras_json(local, load_weights=load_weights, **spec_kw)


def export_keras_weights(topology_path: str, params: Any, out_dir: str,
                         shard_name: str = "group1-shard1of1") -> str:
    """Write a tfjs-layers model.json and one weight shard from trained
    params (a :class:`KerasModel`'s ``{name: tensor}`` parameters, as a
    trainer's ``get_params`` gives them, or a ``{layer: {weight}}`` tree):
    the topology of ``topology_path``, a ``weightsManifest`` naming
    ``<layer>/<weight>`` in sorted order, the values written float32.
    Returns the path of the written model.json."""
    if params and not isinstance(next(iter(params.values())), dict):
        params = _to_wire(torch.float32)(params)
    with open(topology_path) as f:
        topology = json.load(f)
    mt = topology.get("modelTopology", topology)
    os.makedirs(out_dir, exist_ok=True)
    manifest_weights: List[Dict[str, Any]] = []
    blobs = []
    for lname in sorted(params):
        for wname in sorted(params[lname]):
            v = params[lname][wname]
            arr = (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v, np.float32))
            manifest_weights.append({"name": f"{lname}/{wname}", "shape": list(arr.shape),
                                     "dtype": "float32"})
            blobs.append(np.ascontiguousarray(arr).tobytes())
    with open(os.path.join(out_dir, shard_name), "wb") as f:
        f.write(b"".join(blobs))
    out = {"modelTopology": mt,
           "weightsManifest": [{"paths": [shard_name], "weights": manifest_weights}]}
    out_path = os.path.join(out_dir, "model.json")
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out_path


def _input_shape_from(layers: List[Dict[str, Any]]) -> Tuple[int, ...]:
    for layer in layers:
        cfg = layer.get("config", {})
        if "batch_input_shape" in cfg:
            return _feature_shape(cfg["batch_input_shape"], cfg.get("name", "input"))
    raise ValueError("no batch_input_shape found; pass input_shape=")


def _is_last_axis(axis: Any, feature_shape: Optional[Tuple[int, ...]]) -> bool:
    """Does a Keras Softmax-layer ``axis`` denote the LAST tensor axis?"""
    if isinstance(axis, (list, tuple)):
        if len(axis) != 1:
            return False
        axis = axis[0]
    if axis == -1:
        return True
    return feature_shape is not None and axis == len(feature_shape)


def _strip_trailing_softmax(layers: List[Dict[str, Any]], fns: List[LayerFn],
                            names: List[str], out_shape: Optional[Tuple[int, ...]] = None
                            ) -> bool:
    """If the network ends in softmax, replace that final activation with
    identity (in place on ``fns``). Returns True if stripped."""
    last = layers[-1]
    cfg = last.get("config", {})
    if last["class_name"] == "Activation" and cfg.get("activation") == "softmax":
        fns[-1] = lambda params, x: x
        return True
    if last["class_name"] == "Softmax" and _is_last_axis(cfg.get("axis", -1), out_shape):
        fns[-1] = lambda params, x: x
        return True
    if last["class_name"] == "TimeDistributed":
        inner = cfg.get("layer") or {}
        ic = inner.get("config", {})
        if inner.get("class_name") == "Activation" and ic.get("activation") == "softmax":
            fns[-1] = lambda params, x: x
            return True
        if inner.get("class_name") == "Dense" and ic.get("activation") == "softmax":
            fns[-1] = _dense_fn(names[-1], ic.get("use_bias", True))
            return True
    if last["class_name"] == "Dense" and cfg.get("activation") == "softmax":
        # the final Dense minus its activation, under the builder-resolved
        # name (which may be a generated fallback)
        fns[-1] = _dense_fn(names[-1], cfg.get("use_bias", True))
        return True
    return False
