"""Port of ``distriflow_tpu/utils/serialization.py``, dense subset.

``SerializedArray`` (dtype name, shape, raw bytes) and the packed
``dftp-flat`` buffer (``MAGIC | meta_len | meta_json | blob``) that the wire
protocol carries. The bytes are identical to the JAX package's, so a JAX
``InferenceClient`` can talk to the port's server and the reverse.
:func:`serialize_tree`/:func:`deserialize_tree` key a tree's leaves by
path, in JAX's ``keystr`` form (``['params']['embed']``), for checkpoints.

Arrays come in as numpy arrays or CPU tensors. ``bfloat16`` has no numpy
dtype without ``ml_dtypes``, so a ``bfloat16`` payload deserializes to a
CPU ``torch.bfloat16`` tensor; every other dtype deserializes to numpy, as
in the JAX package. Sparse (top-k) and int8-quantized payloads and
``mean_serialized`` belong to the wire-training planes, which are not
ported yet: a blob carrying them is refused rather than misread.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

_SUPPORTED_DTYPES = {
    "float32",
    "float16",
    "bfloat16",
    "float64",
    "int32",
    "int16",
    "int8",
    "uint8",
    "int64",
    "bool",
}


@dataclass(frozen=True)
class SerializedArray:
    """One array on the wire: dtype name, shape, raw bytes. ``scale`` and
    ``indices`` keep the JAX field layout so blobs round-trip through
    :func:`unpack_bytes`; this port refuses to decode them."""

    dtype: str
    shape: Tuple[int, ...]
    data: bytes
    scale: Optional[float] = None
    indices: Optional[bytes] = None

    @property
    def nbytes(self) -> int:
        return len(self.data)


def serialize_array(x: Any) -> SerializedArray:
    """numpy array or CPU tensor -> SerializedArray (host copy)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"serialize_array takes host data; got a tensor on {x.device} "
                "(move it with .cpu() first)")
        t = x.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return SerializedArray(dtype="bfloat16", shape=tuple(t.shape),
                                   data=t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    arr = np.asarray(x)
    name = arr.dtype.name
    if name == "bool_":
        name = "bool"
    if name not in _SUPPORTED_DTYPES:
        raise TypeError(f"unsupported dtype for serialization: {arr.dtype}")
    return SerializedArray(dtype=name, shape=tuple(arr.shape), data=arr.tobytes())


def deserialize_array(s: SerializedArray) -> Union[np.ndarray, torch.Tensor]:
    """SerializedArray -> numpy array (a CPU tensor for ``bfloat16``)."""
    if s.indices is not None or s.scale is not None:
        raise NotImplementedError(
            "sparse and int8-quantized payloads are not ported yet")
    if s.dtype == "bfloat16":
        raw = np.frombuffer(s.data, dtype=np.int16).reshape(s.shape).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    if s.dtype not in _SUPPORTED_DTYPES:
        raise TypeError(f"unsupported dtype on the wire: {s.dtype!r}")
    return np.frombuffer(s.data, dtype=np.dtype(s.dtype)).reshape(s.shape).copy()


_MAGIC = b"DFTP"  # DistriFlow-TPU packed format
_VERSION = 1  # dense-only blobs
_VERSION_SPARSE = 2  # sparse leaves: parsed, then refused by deserialize_array


def flat_serialize(serialized: Dict[str, SerializedArray]) -> Tuple[bytes, Dict[str, Any]]:
    """{name: SerializedArray} -> (packed data blob, meta dict), leaves in
    sorted-name order (format version 1, byte-identical to the JAX writer)."""
    meta: Dict[str, Any] = {"format": "dftp-flat", "version": _VERSION, "leaves": []}
    chunks: List[bytes] = []
    offset = 0
    for key in sorted(serialized):
        s = serialized[key]
        if s.indices is not None:
            raise NotImplementedError("sparse payloads are not ported yet")
        leaf_meta = {
            "name": key,
            "dtype": s.dtype,
            "shape": list(s.shape),
            "byte_offset": offset,
            "nbytes": s.nbytes,
        }
        if s.scale is not None:
            leaf_meta["scale"] = s.scale
        chunks.append(s.data)
        offset += s.nbytes
        meta["leaves"].append(leaf_meta)
    return b"".join(chunks), meta


def flat_deserialize(data: bytes, meta: Dict[str, Any]) -> Dict[str, SerializedArray]:
    """(packed blob, meta dict) -> {name: SerializedArray}."""
    if meta.get("format") != "dftp-flat":
        raise ValueError(f"not a dftp-flat blob: {meta.get('format')!r}")
    version = meta.get("version", _VERSION)
    if version not in (_VERSION, _VERSION_SPARSE):
        raise ValueError(f"unsupported dftp-flat version: {version!r}")
    out: Dict[str, SerializedArray] = {}
    for leaf in meta["leaves"]:
        start = leaf["byte_offset"]
        end = start + leaf["nbytes"]
        indices = None
        if leaf.get("encoding") == "sparse":
            i_start = leaf["indices_offset"]
            indices = data[i_start:i_start + leaf["indices_nbytes"]]
        out[leaf["name"]] = SerializedArray(
            dtype=leaf["dtype"], shape=tuple(leaf["shape"]),
            data=data[start:end], scale=leaf.get("scale"), indices=indices)
    return out


def pack_bytes(serialized: Dict[str, SerializedArray]) -> bytes:
    """Self-describing single-buffer encoding: MAGIC | meta_len | meta_json | blob."""
    blob, meta = flat_serialize(serialized)
    meta_json = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    return _MAGIC + struct.pack("<I", len(meta_json)) + meta_json + blob


def unpack_bytes(buf: bytes) -> Dict[str, SerializedArray]:
    """Inverse of :func:`pack_bytes`."""
    if len(buf) < 8 or buf[:4] != _MAGIC:
        raise ValueError("bad magic: not a dftp packed buffer")
    (meta_len,) = struct.unpack_from("<I", buf, 4)
    if len(buf) < 8 + meta_len:
        raise ValueError(f"truncated dftp buffer: {len(buf)} bytes, meta needs {8 + meta_len}")
    meta = json.loads(buf[8:8 + meta_len].decode("utf-8"))
    blob = buf[8 + meta_len:]
    expected = sum(
        leaf["nbytes"] + leaf.get("indices_nbytes", 0) for leaf in meta.get("leaves", []))
    if len(blob) < expected:
        raise ValueError(f"truncated dftp buffer: blob has {len(blob)} bytes, meta declares {expected}")
    return flat_deserialize(blob, meta)


# -- trees -------------------------------------------------------------------
# A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
# arrays or Python numbers; None is an empty subtree, as in JAX. Dict keys
# flatten in sorted order and paths read like jax.tree_util.keystr.


def _leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _leaves_with_path(t, f"{path}[{i}]")]
    return [(path, tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, f"{path}[{i}]") for i, t in enumerate(tree))
    return fn(path, tree)


def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor detached and copied to the CPU."""
    return tree_map_with_path(
        lambda _, v: v.detach().cpu() if isinstance(v, torch.Tensor) else v, tree)


def serialize_tree(tree: Any) -> Dict[str, SerializedArray]:
    """Tree of host arrays -> {path: SerializedArray}, keyed not positional."""
    return {path: serialize_array(leaf) for path, leaf in _leaves_with_path(tree)}


def deserialize_tree(
    serialized: Dict[str, SerializedArray], like: Any, strict_shapes: bool = True
) -> Any:
    """{path: SerializedArray} -> a tree with the structure of ``like``.

    Each leaf lands as the template leaf's kind and dtype (tensor, numpy
    array or Python number), on the CPU. With ``strict_shapes`` (default),
    a template leaf with a shape must match the serialized shape."""

    def leaf(path: str, template: Any) -> Any:
        if path not in serialized:
            raise KeyError(f"serialized tree missing leaf {path!r}")
        s = serialized[path]
        t_shape = getattr(template, "shape", None)
        if strict_shapes and t_shape is not None and tuple(t_shape) != s.shape:
            raise ValueError(
                f"shape mismatch at {path!r}: serialized {s.shape} vs template {tuple(t_shape)}")
        arr = deserialize_array(s)
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
        if isinstance(template, torch.Tensor):
            return t.to(template.dtype)
        if isinstance(template, np.ndarray):
            return t.float().numpy().astype(template.dtype) if t.dtype == torch.bfloat16 \
                else arr.astype(template.dtype)
        return type(template)(t.item())

    return tree_map_with_path(leaf, like)
