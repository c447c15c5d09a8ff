"""Port of ``distriflow_tpu/parallel/sharding.py``: parameter sharding rules,
path pattern -> placement.

The three rule tables are JAX's, copied as they are (a ``PartitionSpec``
is a tuple of axis names here). The rules match JAX ``keystr`` paths of
the flax tree (``['params']['layers_0']['attn']['q_proj']['kernel']``),
not the port's parameter names: a port name is resolved through its flax
path (:func:`jax_keystr`, over the model's ``ModelSpec.flax_path``:
``models/convert.py::lm_flax_path`` for the LM, flax's own module paths,
the dotted names, for the zoo), so JAX's rule ``.*(q_proj|...).*kernel``
finds ``layers.0.attn.q_proj``, which has no ``kernel`` of its own. The port's flattened layouts shard on the dims
flax's do: ``q_proj`` ``[d, H*D]`` on dim 1 (whole heads), ``o_proj``
``[H*D, d]`` on dim 0.

:func:`shard_params` gives this rank's blocks of a full params dict;
:func:`gather_params` (port-only) is its inverse, for saves,
``get_params`` and the tests.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from distriflow_tpu_torch.parallel.mesh import Placement, axis_size

Spec = Tuple[Optional[str], ...]
# A rule set is an ordered list of (path_regex, spec); first match wins.
Rules = Sequence[Tuple[str, Spec]]
# A port parameter name -> its flax path under ``['params']`` (None: the
# name split on ``.``, as the zoo's names are flax's module paths).
FlaxPath = Optional[Callable[[str], Tuple[str, ...]]]

REPLICATED_RULES: Rules = ((".*", ()),)

# Megatron-style TP for the transformer in models/transformer.py:
# attention qkv + mlp-in are column-sharded, attention-out + mlp-out row-sharded;
# MoE experts additionally shard their leading experts dim over `expert` (EP).
TRANSFORMER_TP_RULES: Rules = (
    (r".*experts_wi", ("expert", None, "model")),
    (r".*experts_wo", ("expert", "model", None)),
    (r".*router.*", ()),
    (r".*(q_proj|k_proj|v_proj|wi|gate).*kernel", (None, "model")),
    (r".*(o_proj|wo).*kernel", ("model", None)),
    (r".*(embed|lm_head).*", (None, "model")),
    (r".*(bias|scale)", ()),
    (r".*", ()),
)

# For the pipelined LM (models/transformer.py::pipelined_transformer_lm):
# stage params carry a leading stages dim sharded over `pipe`; TP specs
# shift right by one dim. Embed/head live outside the pipeline and keep plain TP sharding.
PIPELINED_TRANSFORMER_RULES: Rules = (
    (r".*stages.*experts_wi", ("pipe", "expert", None, "model")),
    (r".*stages.*experts_wo", ("pipe", "expert", "model", None)),
    (r".*stages.*router.*", ("pipe",)),
    (r".*stages.*(q_proj|k_proj|v_proj|wi|gate).*kernel", ("pipe", None, "model")),
    (r".*stages.*(o_proj|wo).*kernel", ("pipe", "model", None)),
    (r".*stages.*", ("pipe",)),
    (r".*(embed|lm_head).*", (None, "model")),
    (r".*(bias|scale)", ()),
    (r".*", ()),
)

def jax_keystr(name: str, flax_path: FlaxPath = None) -> str:
    """The JAX ``keystr`` of the leaf the port names ``name``, under
    ``['params']``, through ``flax_path`` (the model's
    ``ModelSpec.flax_path``)."""
    path = flax_path(name) if flax_path is not None else tuple(name.split("."))
    return "".join(f"['{k}']" for k in ("params",) + path)


def spec_for_path(path: str, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


def _fit_spec_to_rank(spec: Spec, ndim: int) -> Spec:
    """Clip a spec to an array's rank."""
    return tuple(spec)[:ndim]


def spec_for(name: str, ndim: int, rules: Rules, flax_path: FlaxPath = None) -> Spec:
    """The spec of the port parameter ``name`` of rank ``ndim``."""
    return _fit_spec_to_rank(spec_for_path(jax_keystr(name, flax_path), rules), ndim)


def tree_shardings(params: Dict[str, Any], mesh, rules: Rules = REPLICATED_RULES,
                   flax_path: FlaxPath = None) -> Dict[str, Placement]:
    """``{name: Placement}`` for a params dict (full shapes), through ``rules``."""
    return {n: Placement(mesh, spec_for(n, p.dim() if isinstance(p, torch.Tensor) else len(p),
                                        rules, flax_path))
            for n, p in params.items()}


@torch.no_grad()
def shard_params(params: Dict[str, Any], mesh, rules: Rules = REPLICATED_RULES,
                 flax_path: FlaxPath = None) -> Dict[str, torch.Tensor]:
    """This rank's block of every parameter of a full params dict (fresh
    contiguous tensors), per ``rules``."""
    out = {}
    for n, sh in tree_shardings(params, mesh, rules, flax_path).items():
        out[n] = sh.shard(torch.as_tensor(params[n])).clone(memory_format=torch.contiguous_format)
    return out


@torch.no_grad()
def gather_params(params: Dict[str, torch.Tensor], mesh, rules: Rules = REPLICATED_RULES,
                  flax_path: FlaxPath = None) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: every rank's blocks gathered
    into the full tensors (fresh tensors; every rank gets them and must
    call)."""
    from distriflow_tpu_torch.parallel.collectives import _all_gather

    out = {}
    for n, p in params.items():
        full = p.detach().clone()
        for dim, ax in enumerate(spec_for(n, p.dim(), rules, flax_path)):
            if ax is not None:
                full = _all_gather(full, mesh, ax, dim)
        out[n] = full
    return out


def _zero_extend(spec: Spec, shape: Sequence[int], mesh, axis: str) -> Spec:
    """Additionally shard a moment buffer's first shardable dim over ``axis``.

    ZeRO-1 semantics: optimizer state need never be replicated across the
    data-parallel group — each data shard owns a slice. The first dimension
    that is currently unsharded and divisible by the axis size gets it;
    buffers with no such dim keep the param's spec. ``shape`` is the full
    (global) shape."""
    size = axis_size(mesh, axis)
    if size <= 1:
        return tuple(spec)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for entry in spec:  # entries may be axis names or tuples of them
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        elif entry is not None:
            used.add(entry)
    if axis in used:  # a mesh axis may appear at most once per spec
        return tuple(spec)
    for i, dim in enumerate(shape):
        if spec[i] is None and dim % size == 0:
            spec[i] = axis
            return tuple(spec)
    return tuple(spec)


def zero_dim(spec: Spec, shape: Sequence[int], mesh, axis: str = "data") -> Optional[int]:
    """The dim :func:`_zero_extend` gives ``axis`` (None: the buffer stays
    as the param is placed)."""
    ext = _zero_extend(spec, shape, mesh, axis)
    for i, (a, b) in enumerate(zip(ext, list(spec) + [None] * len(shape))):
        if a == axis and b != axis:
            return i
    return None


def opt_state_shardings(opt_state: Dict[str, Any], param_specs: Dict[str, Spec],
                        full_shapes: Dict[str, Sequence[int]], mesh,
                        zero_axis: Optional[str] = None) -> Dict[str, Any]:
    """Placements for the optimizer state (``{"count": n, "mu": {name:
    tensor}, ...}``), mirroring the param placements: each moment leaf gets
    its param's spec, extended over ``zero_axis`` (ZeRO-1) when given;
    counts replicate."""
    out: Dict[str, Any] = {}
    for key, val in opt_state.items():
        if not isinstance(val, dict):
            out[key] = Placement(mesh, ())
            continue
        out[key] = {}
        for n in val:
            spec = param_specs[n]
            if zero_axis is not None:
                spec = _zero_extend(spec, full_shapes[n], mesh, zero_axis)
            out[key][n] = Placement(mesh, spec)
    return out


def describe_shardings(params: Dict[str, Any], mesh, rules: Rules,
                       flax_path: FlaxPath = None) -> str:
    """Human-readable sharding table: the JAX keystr, the full shape and
    the spec of every parameter."""
    lines = []
    for n, p in params.items():
        shape = tuple(p.shape)
        spec = spec_for(n, len(shape), rules, flax_path)
        lines.append(f"{jax_keystr(n, flax_path):60s} {str(shape):20s} {spec}")
    return "\n".join(lines)
