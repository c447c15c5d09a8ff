"""Port of ``distriflow_tpu/models/flax_model.py``: any ``nn.Module`` as a
model of this framework.

Where the JAX package wraps a flax module (whose ``init`` makes a params
tree), the port wraps a zero-argument factory that builds the module:
``init(seed)`` seeds PyTorch's generator, calls the factory and moves the
module to the spec's device. ``input_shape``/``output_shape`` exclude the
batch dim, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from distriflow_tpu_torch.models.base import LearningRate, ModelSpec, SpecModel
from distriflow_tpu_torch.utils.config import CompileConfig


def spec_from_module(
    factory: Callable[[], nn.Module],
    input_shape: Sequence[int],
    output_shape: Sequence[int] = (),
    loss: str = "softmax_cross_entropy",
    name: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> ModelSpec:
    """A ModelSpec whose ``init(seed)`` builds ``factory()`` from ``seed`` on
    ``device`` (``cuda`` by default) and whose ``apply`` calls it.

    On CUDA the spec's ``dtype``, the dtype the module computes in, is read
    from a build on the meta device (the module's ``dtype`` attribute, else
    its first floating parameter's), and a loss whose CUDA kernel cannot
    take it raises ``NotImplementedError`` here
    (:meth:`ModelSpec.check_loss`)."""
    from distriflow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dtype = _module_dtype(factory) if dev.type == "cuda" else None

    def init(seed: int = 0) -> nn.Module:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            module = factory()
        return module.to(dev)

    spec = ModelSpec(
        init=init,
        apply=lambda model, x: model(x),
        loss=loss,
        input_shape=tuple(input_shape),
        output_shape=tuple(output_shape),
        name=name or getattr(factory, "__name__", type(factory).__name__),
        device=dev,
        dtype=dtype,
    )
    spec.check_loss()
    return spec


def _module_dtype(factory: Callable[[], nn.Module]) -> Optional[torch.dtype]:
    """The dtype ``factory()``'s module computes in, from a build on the
    meta device (no memory is allocated)."""
    with torch.device("meta"):
        module = factory()
    dtype = getattr(module, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return dtype
    return next((p.dtype for p in module.parameters() if p.is_floating_point()), None)


class DistributedModuleModel(SpecModel):
    """Stateful parity wrapper over an ``nn.Module`` factory (JAX
    ``DistributedFlaxModel``); the configured loss is honoured."""

    def __init__(
        self,
        factory: Callable[[], nn.Module],
        input_shape: Sequence[int],
        output_shape: Sequence[int] = (),
        compile_config: Optional[CompileConfig] = None,
        learning_rate: Optional[LearningRate] = None,  # None -> 0.001 (reference default)
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        cc = compile_config or CompileConfig()
        spec = spec_from_module(factory, input_shape, output_shape,
                                loss=cc.loss or "softmax_cross_entropy", device=device)
        super().__init__(spec, compile_config=cc, learning_rate=learning_rate, seed=seed)
        self.factory = factory
