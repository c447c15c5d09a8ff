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
by its path in flax's tree. :func:`keras_params_from_jax` carries JAX's
Keras params over. :func:`random_lm_tree` draws a flax-shaped
LM tree from a numpy generator (seeded random weights to carry over).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from distriflow_tpu_torch.models.base import ModelSpec
from distriflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM


def _arr(x: Any, dtype: torch.dtype, shape) -> torch.Tensor:
    a = np.array(x, dtype=np.float32)  # a copy; bf16 leaves widen exactly
    return torch.from_numpy(a).reshape(shape).to(dtype)


#: the port's matmul weights whose flax module holds them as ``kernel``
_LM_KERNELS = ("q_proj", "k_proj", "v_proj", "o_proj", "wi", "wo")


def lm_flax_path(name: str) -> Tuple[str, ...]:
    """The flax path (under ``params``) of the LM parameter the port names
    ``name``: ``layers.3.attn.q_proj`` -> ``("layers_3", "attn", "q_proj",
    "kernel")``, ``embed`` -> ``("embed", "embedding")``. The one name map
    between the two packages: :func:`params_from_jax` reads each leaf
    through it and the sharding rules resolve each name through it
    (``parallel/sharding.py``)."""
    if name == "embed":
        return ("embed", "embedding")
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layers_{parts[1]}"] + parts[2:]
    if parts[-1] in _LM_KERNELS or parts[-1] == "lm_head":
        parts.append("kernel")
    return tuple(parts)


def lm_param_shapes(config: TransformerConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """``{port name: (shape, is_weight)}`` of every LM parameter, in the
    port's flattened layouts (``q_proj`` ``[d, H*D]``, ``o_proj``
    ``[H*D, d]``); ``is_weight`` marks the leaves stored in ``cfg.dtype``
    for serving (LayerNorm and the MoE router stay f32)."""
    cfg = config
    d, hd, e, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_experts, cfg.d_ff
    out = {"embed": ((cfg.vocab_size, d), True), "lm_head": ((d, cfg.vocab_size), True),
           "ln_f.scale": ((d,), False), "ln_f.bias": ((d,), False)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for ln in ("ln_attn", "ln_mlp"):
            out[pre + ln + ".scale"] = ((d,), False)
            out[pre + ln + ".bias"] = ((d,), False)
        for name in ("q_proj", "k_proj", "v_proj"):
            out[pre + "attn." + name] = ((d, hd), True)
        out[pre + "attn.o_proj"] = ((hd, d), True)
        if e > 0:
            out[pre + "moe.experts_wi"] = ((e, d, f), True)
            out[pre + "moe.experts_wo"] = ((e, f, d), True)
            out[pre + "moe.router.kernel"] = ((d, e), False)
            out[pre + "moe.router.bias"] = ((e,), False)
        else:
            out[pre + "mlp.wi"] = ((d, f), True)
            out[pre + "mlp.wo"] = ((f, d), True)
    return out


def params_from_jax(tree: Mapping[str, Any], config: TransformerConfig,
                    masters: bool = False) -> Dict[str, torch.Tensor]:
    """Flax params -> the port's ``state_dict`` (CPU tensors): weights in
    ``config.dtype``, or all f32 with ``masters``. An MoE config's layers
    carry ``moe.experts_wi`` [E, d, f], ``moe.experts_wo`` [E, f, d] (as the
    other weights) and ``moe.router.kernel`` [d, E] / ``.bias`` [E]
    (always f32) in place of ``mlp``. Each leaf is read through
    :func:`lm_flax_path`."""
    p = tree["params"] if "params" in tree else tree
    wdt = torch.float32 if masters else config.dtype
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, weight) in lm_param_shapes(config).items():
        node = p
        for key in lm_flax_path(name):
            node = node[key]
        out[name] = _arr(node, wdt if weight else torch.float32, shape)
    return out


def pipelined_lm_flax_path(name: str) -> Tuple[str, ...]:
    """The path in JAX's pipelined LM tree (``{"embed": {"params": ...},
    "stages": {"params": ...}, "head": {"params": ...}}``) of the
    pipelined LM parameter the port names ``name``: ``embed`` ->
    ``("embed", "params", "embed", "embedding")``,
    ``stages.block_1.attn.q_proj`` -> ``("stages", "params", "block_1",
    "attn", "q_proj", "kernel")``, ``ln_f.scale`` and ``lm_head`` under
    ``("head", "params")``."""
    if name == "embed":
        return ("embed", "params", "embed", "embedding")
    parts = name.split(".")
    if parts[-1] in _LM_KERNELS or parts[-1] == "lm_head":
        parts.append("kernel")
    if parts[0] == "stages":
        return ("stages", "params") + tuple(parts[1:])
    return ("head", "params") + tuple(parts)


def pipelined_param_shapes(config: TransformerConfig, n_stages: int
                           ) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """:func:`lm_param_shapes` of the pipelined LM: ``embed``, ``ln_f.*``,
    ``lm_head``, and each of a stage's ``n_layers / n_stages`` blocks as
    ``stages.block_<i>.*`` with a leading stages dim."""
    per = config.n_layers // n_stages
    out = {}
    for name, (shape, weight) in lm_param_shapes(config).items():
        if not name.startswith("layers."):
            out[name] = (shape, weight)
            continue
        _, i, rest = name.split(".", 2)
        if int(i) < per:
            out[f"stages.block_{i}.{rest}"] = ((n_stages,) + shape, weight)
    return out


def pipelined_params_from_jax(tree: Mapping[str, Any], config: TransformerConfig,
                              n_stages: int, masters: bool = False) -> Dict[str, torch.Tensor]:
    """JAX's pipelined LM tree -> the port's ``PipelinedTransformerLM``
    ``state_dict`` (CPU tensors; f32 with ``masters``), each leaf read
    through :func:`pipelined_lm_flax_path` (``q_proj`` ``[P, d, H, D]`` ->
    ``[P, d, H*D]``)."""
    wdt = torch.float32 if masters else config.dtype
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, weight) in pipelined_param_shapes(config, n_stages).items():
        node = tree
        for key in pipelined_lm_flax_path(name):
            node = node[key]
        out[name] = _arr(node, wdt if weight else torch.float32, shape)
    return out


def pipelined_to_layers(params: Mapping[str, torch.Tensor], n_stages: int
                        ) -> Dict[str, torch.Tensor]:
    """A pipelined LM's parameters as the plain LM's (``stages.block_i.X``
    of stage s -> ``layers.<s * per + i>.X``): the same function run
    without the pipeline."""
    per = len({n.split(".")[1] for n in params if n.startswith("stages.")})
    out = {}
    for name, t in params.items():
        if not name.startswith("stages."):
            out[name] = t
            continue
        _, blk, rest = name.split(".", 2)
        i = int(blk.split("_")[1])
        for st in range(n_stages):
            out[f"layers.{st * per + i}.{rest}"] = t[st]
    return out


def random_pipelined_lm_tree(config: TransformerConfig, n_stages: int,
                             rng: np.random.Generator) -> Dict[str, Any]:
    """A JAX-shaped pipelined LM tree of f32 numpy arrays (``{"embed":
    {"params": ...}, "stages": {"params": {"block_<i>": ...}}, "head":
    {"params": ...}}``): the layers :func:`random_lm_tree` draws from
    ``rng`` stacked into ``n_stages`` stages of ``n_layers / n_stages``
    blocks, so :func:`pipelined_to_layers` of its parameters is that
    tree's."""
    flat = random_lm_tree(config, rng)["params"]
    per = config.n_layers // n_stages
    stages = {f"block_{i}": _stack([flat[f"layers_{s * per + i}"] for s in range(n_stages)])
              for i in range(per)}
    return {"embed": {"params": {"embed": flat["embed"]}},
            "stages": {"params": stages},
            "head": {"params": {"ln_f": flat["ln_f"], "lm_head": flat["lm_head"]}}}


def _stack(trees):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


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


def keras_params_from_jax(tree: Mapping[str, Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
    """JAX's Keras params (``{layer: {weight: array}}``, numpy or JAX
    arrays, any float dtype) -> the ``state_dict`` of the port's
    :class:`~distriflow_tpu_torch.models.keras_import.KerasModel` (CPU f32
    tensors by the port's names, ``<layer>.<weight>``; bf16 leaves widen
    exactly), for ``load_state_dict``, ``SpecModel(params=...)`` or a
    trainer's ``set_params``."""
    from distriflow_tpu_torch.models.keras_import import keras_tree_to_params

    return {n: torch.from_numpy(np.array(v, dtype=np.float32))
            for n, v in keras_tree_to_params(tree).items()}


def with_flax_wire(spec: ModelSpec) -> ModelSpec:
    """``spec`` whose params go on the wire in flax's layout
    (:attr:`ModelSpec.to_wire`): every spec of a module named by flax's
    paths, the zoo's and MobileNetV2's."""
    return dataclasses.replace(spec, to_wire=zoo_params_to_jax, from_wire=_module_params)


def lm_from_jax(config: TransformerConfig, tree: Mapping[str, Any],
                device: Optional[Union[str, torch.device]] = None,
                trainable: bool = False, mesh=None) -> TransformerLM:
    """A :class:`TransformerLM` on ``device`` (``cuda`` by default) that
    computes the same function as the flax module with params ``tree``;
    ``trainable`` carries the f32 masters over into a model to train. With
    ``mesh`` the model holds this rank's blocks under
    ``TRANSFORMER_TP_RULES``, cut by ``models/base.py::cut_blocks``, so it
    carries the table: every rank calls it with the same tree."""
    model = TransformerLM(config, device=device, trainable=trainable, mesh=mesh)
    params = params_from_jax(tree, config, masters=trainable)
    if mesh is None:
        model.load_state_dict(params, strict=True)
        return model
    from distriflow_tpu_torch.models.base import cut_blocks
    from distriflow_tpu_torch.parallel import sharding

    cut_blocks(model, params, mesh, sharding.TRANSFORMER_TP_RULES, lm_flax_path)
    return model


def random_lm_tree(config: TransformerConfig, rng: np.random.Generator) -> Dict[str, Any]:
    """A flax-shaped ``TransformerLM`` params tree (``{"params": ...}``) of
    f32 numpy arrays: every matmul kernel and the embedding drawn
    ``normal(0, 1 / fan_in)`` from ``rng`` in a fixed order (embedding,
    head, then each layer's q, k, v, o, wi, wo), LayerNorm scale 1 and
    bias 0. An MoE config's layers draw, after o, the router kernel
    (fan_in d), ``experts_wi`` (E*d) and ``experts_wo`` (E*f), flax's
    lecun fan-ins; the router bias is 0."""
    d, h, hd, f, v = (config.d_model, config.n_heads, config.head_dim, config.d_ff,
                      config.vocab_size)

    def w(*shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(fan_in))

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    p = {"embed": {"embedding": w(v, d, fan_in=d)}, "ln_f": ln(),
         "lm_head": {"kernel": w(d, v, fan_in=d)}}
    for i in range(config.n_layers):
        attn = {name: {"kernel": w(d, h, hd, fan_in=d)} for name in ("q_proj", "k_proj", "v_proj")}
        attn["o_proj"] = {"kernel": w(h, hd, d, fan_in=h * hd)}
        layer = p[f"layers_{i}"] = {"ln_attn": ln(), "ln_mlp": ln(), "attn": attn}
        e = config.n_experts
        if e > 0:
            layer["moe"] = {"router": {"kernel": w(d, e, fan_in=d),
                                       "bias": np.zeros(e, np.float32)},
                            "experts_wi": w(e, d, f, fan_in=e * d),
                            "experts_wo": w(e, f, d, fan_in=e * f)}
        else:
            layer["mlp"] = {"wi": {"kernel": w(d, f, fan_in=d)},
                            "wo": {"kernel": w(f, d, fan_in=f)}}
    return {"params": p}
