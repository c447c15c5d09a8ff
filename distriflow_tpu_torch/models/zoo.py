"""Port of ``distriflow_tpu/models/zoo.py``: the benchmark-config model
families.

- :func:`mnist_mlp`: flatten -> dense(hidden, relu) -> dense(10) logits
  (BASELINE config #1);
- :func:`mnist_convnet`: the reference's Keras ConvNet family (conv 32/64,
  dense 128) on 28x28x1;
- :func:`cifar_convnet`: conv 64/128/256, dense 256, 10 classes on
  32x32x3 (BASELINE config #2/#3);
- :func:`flagship_lm_config` is the bench-flagship LM (bench.py's
  ``transformer_lm_flagship`` row) and :func:`draft_lm_config` the zoo's
  small LM; both name their dimensions once so scripts and tests do not
  repeat them.

The modules are flax's module for module, with flax's names (``Conv_0``,
``Dense_1``), so :func:`~distriflow_tpu_torch.models.convert.zoo_params_from_jax`
maps a flax params tree onto the ``state_dict``. Inputs are NHWC, as in
JAX; convolutions are flax's ``SAME`` (pad 1 at 3x3) with a bias, max
pooling is 2x2 stride 2 ``VALID``, and the flatten before the first
``Dense`` runs in (h, w, c) order. Parameters are f32 masters cast to
``dtype`` on every call (default f32; pass ``torch.bfloat16`` for the
tensor cores). The specs compute ``softmax_cross_entropy`` on one-hot
targets, as JAX's; ``dataclasses.replace(spec,
loss="fused_softmax_cross_entropy")`` trains through the fused dense CE
kernels, which take bf16 logits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from distriflow_tpu_torch.models.base import ModelSpec
from distriflow_tpu_torch.models.mobilenet import Conv, Dense
from distriflow_tpu_torch.models.module_model import spec_from_module
from distriflow_tpu_torch.models.transformer import TransformerConfig

Device = Optional[Union[str, torch.device]]


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> [B, H*W*C] in flax's (h, w, c) order."""
    return x.reshape(x.shape[0], -1)


class MLP(nn.Module):
    """flatten -> dense(hidden, relu) -> dense(classes) logits."""

    def __init__(self, in_features: int, hidden: int = 10, classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("Dense_0", Dense(in_features, hidden, dtype))
        self.add_module("Dense_1", Dense(hidden, classes, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _flatten_hwc(x).to(self.dtype)
        return self._modules["Dense_1"](F.relu(self._modules["Dense_0"](x)))


class ConvNet(nn.Module):
    """(conv 3x3 SAME, relu, max-pool 2x2) per feature count, then dense
    (relu) and the class logits; NHWC ``input_shape`` ``(H, W, C)``."""

    def __init__(self, input_shape: Tuple[int, int, int], features: Sequence[int] = (32, 64),
                 classes: int = 10, dense: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        h, w, ch = input_shape
        for i, f in enumerate(features):
            self.add_module(f"Conv_{i}", Conv(ch, f, (3, 3), 1, 1, dtype, use_bias=True))
            h, w, ch = h // 2, w // 2, f
        self.convs = [self._modules[f"Conv_{i}"] for i in range(len(features))]
        self.add_module("Dense_0", Dense(h * w * ch, dense, dtype))
        self.add_module("Dense_1", Dense(dense, classes, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for conv in self.convs:
            y = F.relu(conv(x))
            x = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = F.relu(self._modules["Dense_0"](_flatten_hwc(x)))
        return self._modules["Dense_1"](x)


def mnist_mlp(hidden: int = 10, dtype: torch.dtype = torch.float32,
              device: Device = None) -> ModelSpec:
    """BASELINE config #1 model (reference ``mnist_server.ts:16-22``) on
    ``device`` (``cuda`` by default)."""
    return spec_from_module(lambda: MLP(28 * 28, hidden=hidden, classes=10, dtype=dtype),
                            input_shape=(28, 28, 1), output_shape=(10,), name="mnist_mlp",
                            device=device)


def mnist_convnet(dtype: torch.dtype = torch.float32, device: Device = None) -> ModelSpec:
    """Reference ``experiment/mnist/model.json`` ConvNet family."""
    return spec_from_module(
        lambda: ConvNet((28, 28, 1), features=(32, 64), classes=10, dense=128, dtype=dtype),
        input_shape=(28, 28, 1), output_shape=(10,), name="mnist_convnet", device=device)


def cifar_convnet(dtype: torch.dtype = torch.float32, device: Device = None) -> ModelSpec:
    """BASELINE config #2/#3 model."""
    return spec_from_module(
        lambda: ConvNet((32, 32, 3), features=(64, 128, 256), classes=10, dense=256, dtype=dtype),
        input_shape=(32, 32, 3), output_shape=(10,), name="cifar_convnet", device=device)


def flagship_lm_config(max_seq: int = 2048, dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """vocab 32000, d_model 512, 8 heads x 64, 8 layers, d_ff 2048."""
    return TransformerConfig(
        vocab_size=32000, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
        max_seq=max_seq, dtype=dtype)


def draft_lm_config(max_seq: int = 2048, dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """The small LM: 2 layers at a quarter of the flagship's width (head
    dim 32, which the CUDA kernels are not built for: on the card it runs
    with ``use_flash_attention=False`` and ``use_flash_decode=False``)."""
    return TransformerConfig(
        vocab_size=32000, d_model=128, n_heads=4, n_layers=2, d_ff=512,
        max_seq=max_seq, dtype=dtype)
