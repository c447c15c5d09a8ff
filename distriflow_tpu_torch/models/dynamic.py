"""Port of ``distriflow_tpu/models/dynamic.py``: the hand-rolled 'dynamic'
model wrapper (the reference's ``DistributedDynamicModel``), the same
DistributedModel surface for users who bring their own variables and an
apply closure rather than a layers model.

Here: a ``{name: tensor}`` params dict and ``apply(params, x)``, where
``params`` is that dict of the model's live parameters (the port's
counterpart of JAX's params pytree), and a loss name from the registry.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from distriflow_tpu_torch.models.base import ModelSpec, SpecModel
from distriflow_tpu_torch.utils.config import CompileConfig
from distriflow_tpu_torch.utils.device import canonical_dtype


class _Params(nn.Module):
    """The user's tensors as parameters (in the dtypes ``jnp.asarray`` gives
    them); a dotted name nests one child module a segment, so
    ``named_parameters`` gives the names back."""

    def __init__(self, params: Mapping[str, Any]):
        super().__init__()
        for name, v in params.items():
            *parents, leaf = name.split(".")
            mod: nn.Module = self
            for part in parents:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            t = canonical_dtype(torch.as_tensor(v)).detach().clone()
            mod.register_parameter(leaf, nn.Parameter(t, requires_grad=t.is_floating_point()))


class DistributedDynamicModel(SpecModel):
    """DistributedModel over raw params and an apply closure, on ``device``
    (``cuda`` by default)."""

    def __init__(
        self,
        params: Mapping[str, Any],
        apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
        loss: str = "softmax_cross_entropy",
        input_shape: Sequence[int] = (),
        output_shape: Sequence[int] = (),
        learning_rate: Optional[float] = None,  # None -> 0.001 (reference default)
        name: str = "dynamic",
        device: Optional[Union[str, torch.device]] = None,
    ):
        from distriflow_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        initial = dict(params)
        spec = ModelSpec(
            init=lambda seed=0: _Params(initial).to(dev),
            apply=lambda model, x: apply_fn(dict(model.named_parameters()), x),
            loss=loss,
            input_shape=tuple(input_shape),
            output_shape=tuple(output_shape),
            name=name,
            device=dev,
        )
        super().__init__(spec, compile_config=CompileConfig(loss=loss),
                         learning_rate=learning_rate)
