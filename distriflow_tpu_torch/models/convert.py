"""Weight carry-over from the JAX package (no JAX counterpart).

:func:`params_from_jax` maps a flax ``TransformerLM`` params tree, given as
nested dicts of numpy arrays (``{"params": {...}}`` or the inner dict), to
a ``state_dict`` of :class:`~distriflow_tpu_torch.models.transformer.TransformerLM`.

- For serving (the default) matmul weights and the embedding are cast to
  ``config.dtype`` once here — the same values flax produces by casting
  the f32 master params on every call; LayerNorm parameters stay f32, as
  flax keeps them.
- For training (``masters=True``) every parameter stays f32, the flax
  master params bit for bit, so a JAX trainer and the port's start from
  the same bits; the trainable model casts them inside ``forward``.

:func:`mobilenet_params_from_jax` does the same for a flax MobileNetV2
tree, and :func:`zoo_params_from_jax` for the zoo's MLP and ConvNet (f32
masters only; the models cast them on every call).
:func:`zoo_params_to_jax` is the exact inverse of both: the wire layout
of those specs (:func:`with_flax_wire`), since the wire keys every leaf
by its path in flax's tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from distriflow_tpu_torch.models.base import ModelSpec
from distriflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM


def _arr(x: Any, dtype: torch.dtype, shape) -> torch.Tensor:
    a = np.array(x, dtype=np.float32)  # a copy; bf16 leaves widen exactly
    return torch.from_numpy(a).reshape(shape).to(dtype)


def params_from_jax(tree: Mapping[str, Any], config: TransformerConfig,
                    masters: bool = False) -> Dict[str, torch.Tensor]:
    """Flax params -> the port's ``state_dict`` (CPU tensors): weights in
    ``config.dtype``, or all f32 with ``masters``."""
    p = tree["params"] if "params" in tree else tree
    cfg = config
    hd = cfg.n_heads * cfg.head_dim
    wdt = torch.float32 if masters else cfg.dtype
    out: Dict[str, torch.Tensor] = {
        "embed": _arr(p["embed"]["embedding"], wdt, (cfg.vocab_size, cfg.d_model)),
        "lm_head": _arr(p["lm_head"]["kernel"], wdt, (cfg.d_model, cfg.vocab_size)),
        "ln_f.scale": _arr(p["ln_f"]["scale"], torch.float32, (cfg.d_model,)),
        "ln_f.bias": _arr(p["ln_f"]["bias"], torch.float32, (cfg.d_model,)),
    }
    for i in range(cfg.n_layers):
        lp = p[f"layers_{i}"]
        pre = f"layers.{i}."
        for ln in ("ln_attn", "ln_mlp"):
            out[pre + ln + ".scale"] = _arr(lp[ln]["scale"], torch.float32, (cfg.d_model,))
            out[pre + ln + ".bias"] = _arr(lp[ln]["bias"], torch.float32, (cfg.d_model,))
        attn = lp["attn"]
        for name in ("q_proj", "k_proj", "v_proj"):
            out[pre + "attn." + name] = _arr(attn[name]["kernel"], wdt, (cfg.d_model, hd))
        out[pre + "attn.o_proj"] = _arr(attn["o_proj"]["kernel"], wdt, (hd, cfg.d_model))
        out[pre + "mlp.wi"] = _arr(lp["mlp"]["wi"]["kernel"], wdt, (cfg.d_model, cfg.d_ff))
        out[pre + "mlp.wo"] = _arr(lp["mlp"]["wo"]["kernel"], wdt, (cfg.d_ff, cfg.d_model))
    return out


def mobilenet_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax MobileNetV2 params -> the port's ``state_dict`` (CPU tensors,
    every one the f32 master bit for bit). Module paths are flax's
    (``InvertedResidual_3._ConvNorm_1.GroupNorm_0.scale``); ``Conv_0``
    kernels go from HWIO to OIHW; the fused and shift depthwise kernel, a
    ``kernel`` directly under a ``_ConvNorm``, from ``[3, 3, 1, C]`` to
    ``[3, 3, C]``; everything else keeps its shape."""
    return _module_params(tree)


def zoo_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of a zoo ``MLP`` or ``ConvNet`` -> the port's
    ``state_dict`` (CPU tensors, the f32 masters bit for bit). Module names
    are flax's (``Conv_1.kernel``, ``Dense_0.bias``); ``Conv_*`` kernels go
    from HWIO to OIHW; ``Dense_*`` kernels keep flax's ``[in, out]``, the
    layout the port's ``Dense`` computes with."""
    return _module_params(tree)


def _module_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of a module tree -> a ``state_dict`` by flax's module
    paths, every leaf f32, with the layout changes both converters name."""
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple) -> None:
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (name,))
                continue
            a = np.array(v, dtype=np.float32)
            if name == "kernel" and path[-1].startswith("Conv_"):
                a = a.transpose(3, 2, 0, 1)
            elif name == "kernel" and path[-1].startswith("_ConvNorm_"):
                a = a.reshape(3, 3, a.shape[-1])
            out[".".join(path + (name,))] = torch.from_numpy(np.ascontiguousarray(a))

    walk(p, ())
    return out


def zoo_params_to_jax(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``state_dict`` (or a gradient dict of the same names) of a
    zoo ``MLP``/``ConvNet`` or a MobileNetV2 -> flax's ``{"params": {...}}``
    tree of host numpy arrays: the exact inverse of
    :func:`zoo_params_from_jax` and :func:`mobilenet_params_from_jax`
    (names split on ``.`` into flax's nesting; ``Conv_*`` kernels OIHW ->
    HWIO, a ``_ConvNorm``'s own ``[3, 3, C]`` kernel -> ``[3, 3, 1, C]``;
    every leaf a fresh array in its own dtype, its bits unchanged)."""
    from distriflow_tpu_torch.utils.serialization import to_numpy

    out: Dict[str, Any] = {}
    for name, v in params.items():
        path = name.split(".")
        a = np.array(to_numpy(v), copy=True)
        if path[-1] == "kernel" and len(path) > 1 and path[-2].startswith("Conv_"):
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif path[-1] == "kernel" and len(path) > 1 and path[-2].startswith("_ConvNorm_"):
            a = a.reshape(3, 3, 1, a.shape[-1])
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = a
    return {"params": out}


def with_flax_wire(spec: ModelSpec) -> ModelSpec:
    """``spec`` whose params go on the wire in flax's layout
    (:attr:`ModelSpec.to_wire`): every spec of a module named by flax's
    paths, the zoo's and MobileNetV2's."""
    return dataclasses.replace(spec, to_wire=zoo_params_to_jax, from_wire=_module_params)


def lm_from_jax(config: TransformerConfig, tree: Mapping[str, Any],
                device: Optional[Union[str, torch.device]] = None,
                trainable: bool = False) -> TransformerLM:
    """A :class:`TransformerLM` on ``device`` (``cuda`` by default) that
    computes the same function as the flax module with params ``tree``;
    ``trainable`` carries the f32 masters over into a model to train."""
    model = TransformerLM(config, device=device, trainable=trainable)
    model.load_state_dict(params_from_jax(tree, config, masters=trainable), strict=True)
    return model
