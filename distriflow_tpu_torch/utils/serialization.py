"""Port of ``distriflow_tpu/utils/serialization.py``.

``SerializedArray`` (dtype name, shape, raw bytes, an optional int8
``scale`` and optional sparse ``indices``) and the packed ``dftp-flat``
buffer (``MAGIC | meta_len | meta_json | blob``) that the wire protocol
carries. The bytes are identical to the JAX package's for the same arrays
(dense, int8-quantized and top-k sparse leaves alike), so a JAX client
talks to the port's server and the reverse. Trees key their leaves by
path, in JAX's ``keystr`` form (``['params']['Conv_0']['kernel']``).

Arrays come in as numpy arrays or tensors (a tensor off the CPU must be
moved with ``.cpu()`` first). ``bfloat16`` has no numpy dtype without
``ml_dtypes``: a ``bfloat16`` payload deserializes to a CPU
``torch.bfloat16`` tensor, and where the JAX package does arithmetic on a
bfloat16 array the port widens its bits to f32 first, which is exact.
``ml_dtypes``' bfloat16 is not of numpy kind ``"f"`` (its kind is
``"V"``), so the JAX package treats it as a non-float leaf in
:func:`cast_tree`, delta broadcasts and :func:`mean_serialized`'s choice
of accumulator; the port mirrors that (:func:`_kind`).

:func:`mean_serialized` is the federated aggregation's host loop: f32
accumulation for float leaves of 32 bits or less, f64 for the rest, the
result in the template's dtype, through the port's own ``native`` mean
kernel where the JAX package uses its own.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

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
    """One array on the wire: dtype name, shape, raw bytes.

    ``scale`` (optional) marks a symmetric-quantized payload: the logical
    array is ``frombuffer(data, dtype) * scale`` in float32
    (:func:`quantize_array`). ``indices`` (optional) marks a *sparse*
    payload: ``data`` holds only the values at the int32 flat positions in
    ``indices`` (unique, ascending), ``shape`` stays the dense shape and
    every unlisted position is zero (:func:`topk_array`); ``scale``
    composes."""

    dtype: str
    shape: Tuple[int, ...]
    data: bytes
    scale: Optional[float] = None
    indices: Optional[bytes] = None

    @property
    def is_sparse(self) -> bool:
        return self.indices is not None

    @property
    def nbytes(self) -> int:
        """Value-payload bytes only (the data blob's chunk length)."""
        return len(self.data)

    @property
    def wire_nbytes(self) -> int:
        """Total payload bytes on the wire: values + index vector."""
        return len(self.data) + (len(self.indices) if self.indices is not None else 0)


# -- dtypes --------------------------------------------------------------------


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype of a wire dtype name. ``bfloat16`` has none here:
    use :func:`_values` (its bits widened to f32) or a torch tensor."""
    if name == "bfloat16":
        raise TypeError("bfloat16 has no numpy dtype in the port; its values widen to f32")
    return np.dtype(name)


def _kind(name: str) -> str:
    """numpy's kind letter of a wire dtype; ``"V"`` for bfloat16, as
    ``ml_dtypes`` gives it (so bfloat16 is not a float leaf in JAX's tests)."""
    return "V" if name == "bfloat16" else np.dtype(name).kind


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _dtype_name(x: Any) -> Optional[str]:
    """The wire dtype name of an array or tensor (None for a leaf without one)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    dt = getattr(x, "dtype", None)
    if dt is None:
        return None
    name = np.dtype(dt).name
    return "bool" if name == "bool_" else name


def _values(data: bytes, name: str) -> np.ndarray:
    """A flat read-only view of a payload's values; bfloat16 bits widen to
    f32 (a fresh array, exact)."""
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return np.frombuffer(data, dtype=_np_dtype(name))


def _bf16_tensor(values: np.ndarray) -> torch.Tensor:
    """f32/f64 values -> a CPU bfloat16 tensor (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(torch.bfloat16)


def _land(arr: np.ndarray, name: str, template: Any = None) -> Any:
    """``arr`` in dtype ``name``, as the template's kind: a CPU tensor for a
    tensor template or a bfloat16 result, else a numpy array."""
    if name == "bfloat16" or isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(getattr(torch, name))
    want = _np_dtype(name)
    return arr if arr.dtype == want else arr.astype(want)


def to_numpy(x: Any) -> Union[np.ndarray, torch.Tensor]:
    """A host copy of an array or tensor as numpy; a bfloat16 tensor stays
    a CPU bfloat16 tensor (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def _f32(x: Any) -> np.ndarray:
    """Values of an array or tensor as f32 numpy (bfloat16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _is_float(x: Any) -> bool:
    """numpy kind ``"f"``: float16/32/64, not bfloat16 (see :func:`_kind`)."""
    name = _dtype_name(x)
    return name is not None and _kind(name) == "f"


# -- arrays --------------------------------------------------------------------


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


def _dequantize(raw: np.ndarray, scale: float) -> np.ndarray:
    """The ONE dequantization rule: payload * scale in float32."""
    return raw.astype(np.float32) * np.float32(scale)


def deserialize_array(s: SerializedArray) -> Union[np.ndarray, torch.Tensor]:
    """SerializedArray -> numpy array (a CPU tensor for ``bfloat16``).

    Quantized payloads (``scale`` set) dequantize to float32. Sparse
    payloads (``indices`` set) densify: zeros at every unlisted position."""
    if s.dtype not in _SUPPORTED_DTYPES:
        raise TypeError(f"unsupported dtype on the wire: {s.dtype!r}")
    if s.indices is not None:
        idx = np.frombuffer(s.indices, dtype=np.int32)
        raw = _values(s.data, s.dtype)
        if idx.size != raw.size:
            raise ValueError(
                f"sparse payload mismatch: {idx.size} indices vs {raw.size} values")
        n = int(np.prod(s.shape, dtype=np.int64)) if s.shape else 1
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(f"sparse index out of range for dense shape {s.shape}")
        if s.scale is not None:
            dense = np.zeros(n, np.float32)
            dense[idx] = _dequantize(raw, s.scale)
            return dense.reshape(s.shape)
        dense = np.zeros(n, raw.dtype)
        dense[idx] = raw
        dense = dense.reshape(s.shape)
        return _bf16_tensor(dense) if s.dtype == "bfloat16" else dense
    if s.dtype == "bfloat16":
        raw = np.frombuffer(s.data, dtype=np.int16).reshape(s.shape).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    raw = np.frombuffer(s.data, dtype=np.dtype(s.dtype)).reshape(s.shape)
    if s.scale is not None:
        return _dequantize(raw, s.scale)
    return raw.copy()


def sanitize_finite(x: np.ndarray) -> np.ndarray:
    """Zero out non-finite entries (loss-overflow inf/nan gradients).

    Quantization MUST see finite values: an inf absmax would make
    scale=inf and the payload all-NaN. Callers carrying error feedback
    compute the residual against the sanitized value."""
    if np.all(np.isfinite(x)):
        return x
    return np.where(np.isfinite(x), x, 0.0).astype(x.dtype, copy=False)


def quantize_array(x: Any) -> SerializedArray:
    """Symmetric per-leaf int8 quantization: scale = absmax/127, payload =
    round(x/scale) in int8 (4x fewer wire bytes than float32); non-finite
    entries are zeroed first (:func:`sanitize_finite`)."""
    arr = sanitize_finite(_f32(x))
    absmax = float(np.max(np.abs(arr))) if arr.size else 0.0
    scale = absmax / 127.0 if absmax > 0 else 1.0
    q = np.clip(np.rint(arr / scale), -127, 127).astype(np.int8)
    return SerializedArray(dtype="int8", shape=tuple(arr.shape),
                           data=q.tobytes(), scale=scale)


def topk_array(x: Any, fraction: float, quantize: bool = False) -> SerializedArray:
    """Top-|k| sparsification: ship only the ``k = max(1, round(fraction*n))``
    largest-magnitude entries as (sorted int32 flat indices, values),
    int8-quantized with ``quantize``. ``deserialize_array`` of the result
    is exactly the dense tensor the server sees, so ``residual = g -
    deserialize_array(sa)`` carries the un-sent mass forward."""
    arr = sanitize_finite(_f32(x))
    shape = tuple(arr.shape)
    flat = arr.reshape(-1)
    n = flat.size
    if n == 0:
        return SerializedArray(
            dtype="int8" if quantize else "float32", shape=shape, data=b"",
            scale=1.0 if quantize else None, indices=b"")
    k = min(n, max(1, int(round(float(fraction) * n))))
    if k >= n:
        idx = np.arange(n, dtype=np.int32)
    else:
        part = np.argpartition(np.abs(flat), n - k)[n - k:]
        idx = np.sort(part).astype(np.int32)
    vals = flat[idx]
    if quantize:
        q = quantize_array(vals)
        return SerializedArray(dtype="int8", shape=shape, data=q.data,
                               scale=q.scale, indices=idx.tobytes())
    return SerializedArray(dtype="float32", shape=shape,
                           data=vals.tobytes(), indices=idx.tobytes())


def tree_wire_nbytes(serialized: Dict[str, SerializedArray]) -> int:
    """Total wire payload bytes of a serialized tree (values + sparse indices)."""
    return sum(s.wire_nbytes for s in serialized.values())


# -- trees ---------------------------------------------------------------------
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


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in JAX's flattening order (dict keys sorted)."""
    return [leaf for _, leaf in _leaves_with_path(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, f"{path}[{i}]") for i, t in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)`` (``jax.tree.map``)."""
    return tree_map_with_path(lambda _, v: fn(v), tree)


def batch_rows(tree: Any) -> int:
    """The rows of a batch tree (an array, or a tuple of them for a model
    of several inputs or outputs): its first leaf's dim 0."""
    return len(tree_leaves(tree)[0])


def tree_map2(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    """``fn`` over the leaves of two trees of the same structure (JAX's
    ``jax.tree.map(fn, a, b)``); a structure mismatch raises ``ValueError``."""
    if a is None:
        if b is not None:
            raise ValueError("tree structures differ")
        return None
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise ValueError("tree structures differ")
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise ValueError("tree structures differ")
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def copy_tree(tree: Any) -> Any:
    """A copy of every array leaf where it lies (a tensor stays on its
    device): the servers' rollback snapshot, which in-place updates must
    not reach."""
    return tree_map_with_path(
        lambda _, v: v.detach().clone() if isinstance(v, torch.Tensor)
        else np.array(v, copy=True), tree)


def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor detached and copied to the CPU."""
    return tree_map_with_path(
        lambda _, v: v.detach().cpu() if isinstance(v, torch.Tensor) else v, tree)


def cast_tree(tree: Any, dtype_name: str) -> Any:
    """Cast every FLOAT leaf (numpy kind ``"f"``) of a host tree to
    ``dtype_name``; non-float leaves (ints, bools, and bfloat16, as in the
    JAX package) pass through untouched."""
    if dtype_name not in _SUPPORTED_DTYPES:
        raise TypeError(f"unsupported dtype: {dtype_name!r}")

    def cast(_: str, v: Any) -> Any:
        arr = to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        if not _is_float(arr):
            return arr
        return _bf16_tensor(arr) if dtype_name == "bfloat16" else arr.astype(_np_dtype(dtype_name))

    return tree_map_with_path(cast, tree)


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


def mean_serialized(
    updates: Sequence[Dict[str, SerializedArray]],
    like: Any,
    weights: Optional[Sequence[float]] = None,
) -> Any:
    """Mean of N clients' serialized gradient trees -> a tree shaped ``like``.

    The federated aggregation loop, per leaf over buffer views: the port's
    ``native`` mean kernel for unweighted dense float leaves of 32 bits or
    less, numpy otherwise. ``weights`` (one float per update) scale each
    contribution inside the accumulation: result = sum(w_i * g_i) / N.
    Updates may mix dtypes per leaf. Float leaves of 32 bits or less
    accumulate in float32; float64, integer (and bfloat16, see the module
    note) leaves in float64. Sparse updates scatter-add into the dense
    accumulator; int8 updates dequant-accumulate through one scratch
    buffer. The result lands on the template leaf's dtype."""
    if not updates:
        raise ValueError("mean_serialized needs at least one update")
    if weights is not None:
        if len(weights) != len(updates):
            raise ValueError(
                f"weights length {len(weights)} != updates length {len(updates)}")
        weights = [float(w) for w in weights]
        if all(w == 1.0 for w in weights):
            weights = None  # plain mean: keep the native fast path eligible
    _validate_matching_leaves(updates, check_dtype=False)
    from distriflow_tpu_torch import native

    def leaf(key: str, template: Any) -> Any:
        if key not in updates[0]:
            raise KeyError(f"updates missing leaf {key!r}")
        first = updates[0][key]
        t_shape = getattr(template, "shape", None)
        if t_shape is not None and tuple(t_shape) != first.shape:
            raise ValueError(
                f"shape mismatch at {key!r}: update {first.shape} vs template {tuple(t_shape)}")
        leaf_updates = [u[key] for u in updates]

        def raw_view(sa):
            return _values(sa.data, sa.dtype).reshape(first.shape)

        def sparse_parts(sa):
            return np.frombuffer(sa.indices, dtype=np.int32), _values(sa.data, sa.dtype)

        has_sparse = any(sa.indices is not None for sa in leaf_updates)
        has_quant = any(sa.scale is not None for sa in leaf_updates)
        # float64/integer/bfloat16 *unquantized dense* leaves force the wide
        # path; quantized and sparse contributions always land as float32
        wide = any(
            sa.indices is None and sa.scale is None
            and not (_kind(sa.dtype) == "f" and _itemsize(sa.dtype) <= 4)
            for sa in leaf_updates)
        t_name = _dtype_name(template) or (
            "float32" if (has_quant or has_sparse) else leaf_updates[0].dtype)
        if weights is None and not wide and not has_sparse and not has_quant:
            mean = native.mean_buffers([raw_view(sa) for sa in leaf_updates])
        elif not wide:
            acc = np.zeros(first.shape, np.float32)
            flat_acc = acc.reshape(-1)
            scratch = None
            for i, sa in enumerate(leaf_updates):
                w = np.float32(1.0 if weights is None else weights[i])
                if sa.indices is not None:
                    idx, raw = sparse_parts(sa)
                    vals = (_dequantize(raw, sa.scale) if sa.scale is not None
                            else raw.astype(np.float32))
                    if w != 1.0:
                        vals = w * vals
                    np.add.at(flat_acc, idx, vals)
                elif sa.scale is not None:
                    if scratch is None:
                        scratch = np.empty(first.shape, np.float32)
                    np.multiply(raw_view(sa), np.float32(sa.scale), out=scratch)
                    if w != 1.0:
                        scratch *= w
                    acc += scratch
                else:
                    v = raw_view(sa)
                    if w != 1.0:
                        acc += w * v.astype(np.float32)
                    else:
                        acc += v.astype(np.float32, copy=False)
            mean = acc / np.float32(len(leaf_updates))
        else:
            # f64 accumulation keeps the full mantissa (int means are exact
            # below 2^53)
            acc = np.zeros(first.shape, np.float64)
            flat_acc = acc.reshape(-1)
            for i, sa in enumerate(leaf_updates):
                w = 1.0 if weights is None else weights[i]
                if sa.indices is not None:
                    idx, raw = sparse_parts(sa)
                    vals = _dequantize(raw, sa.scale) if sa.scale is not None else raw
                    np.add.at(flat_acc, idx, w * vals.astype(np.float64))
                else:
                    v = raw_view(sa)
                    if sa.scale is not None:
                        v = _dequantize(v, sa.scale)
                    acc += w * v.astype(np.float64)
            mean = acc / len(leaf_updates)
        if _kind(t_name) in "iu":
            mean = np.rint(mean)
        return _land(mean, t_name, template)

    return tree_map_with_path(leaf, like)


def _validate_matching_leaves(
    updates: Sequence[Dict[str, SerializedArray]], check_dtype: bool = True
) -> None:
    """Cross-update invariants: key sets and shapes always; dtypes only where
    the consumer needs homogeneous buffers (byte-level stacking)."""
    keys = set(updates[0].keys())
    for i, u in enumerate(updates[1:], start=1):
        if set(u.keys()) != keys:
            raise ValueError(f"update {i} has mismatched leaves vs update 0")
        for key in keys:
            s, first = u[key], updates[0][key]
            if s.shape != first.shape or (check_dtype and s.dtype != first.dtype):
                raise ValueError(
                    f"leaf {key!r} mismatch: {s.dtype}{s.shape} vs "
                    f"{first.dtype}{first.shape}")


def stack_serialized(updates: Sequence[Dict[str, SerializedArray]]) -> Dict[str, SerializedArray]:
    """Stack N clients' serialized trees into one tree with leading dim N.

    Homogeneous unquantized dense leaves are joined byte for byte;
    quantized or sparse leaves carry per-update scales and indices a byte
    join would lose, so each is decoded and the stacked leaf lands dense
    float32."""
    if not updates:
        raise ValueError("stack_serialized needs at least one update")
    _validate_matching_leaves(updates, check_dtype=False)
    out: Dict[str, SerializedArray] = {}
    n = len(updates)
    for key in updates[0]:
        leaf_updates = [u[key] for u in updates]
        first = leaf_updates[0]
        if any(sa.scale is not None or sa.indices is not None for sa in leaf_updates):
            stacked = np.empty((n,) + first.shape, np.float32)
            for i, sa in enumerate(leaf_updates):
                stacked[i] = _f32(deserialize_array(sa))
            out[key] = SerializedArray(
                dtype="float32", shape=(n,) + first.shape, data=stacked.tobytes())
            continue
        if any(sa.dtype != first.dtype for sa in leaf_updates):
            raise ValueError(
                f"leaf {key!r} mixes dtypes across updates and cannot be byte-stacked")
        out[key] = SerializedArray(
            dtype=first.dtype, shape=(n,) + first.shape,
            data=b"".join(sa.data for sa in leaf_updates))
    return out


# -- the packed flat format ------------------------------------------------------

_MAGIC = b"DFTP"  # DistriFlow-TPU packed format
_VERSION = 1  # dense-only blobs (all pre-sparse readers parse these)
_VERSION_SPARSE = 2  # >=1 sparse leaf: per-leaf encoding="sparse" + index chunk


def flat_serialize(serialized: Dict[str, SerializedArray]) -> Tuple[bytes, Dict[str, Any]]:
    """{name: SerializedArray} -> (packed data blob, meta dict), leaves in
    sorted-name order. Dense-only trees emit format version 1; a tree with
    any sparse leaf emits version 2, whose sparse leaf's value chunk is
    followed by its int32 index chunk (``indices_offset``/``indices_nbytes``,
    ``encoding="sparse"``): byte-identical to the JAX writer."""
    meta: Dict[str, Any] = {"format": "dftp-flat", "version": _VERSION, "leaves": []}
    chunks: List[bytes] = []
    offset = 0
    for key in sorted(serialized):
        s = serialized[key]
        leaf_meta = {  # dfcheck: payload dftp_leaf
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
        if s.indices is not None:
            meta["version"] = _VERSION_SPARSE
            leaf_meta["encoding"] = "sparse"
            leaf_meta["index_dtype"] = "int32"
            leaf_meta["indices_offset"] = offset
            leaf_meta["indices_nbytes"] = len(s.indices)
            chunks.append(s.indices)
            offset += len(s.indices)
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
    for leaf in meta["leaves"]:  # dfcheck: payload dftp_leaf
        start = leaf["byte_offset"]
        end = start + leaf["nbytes"]
        indices = None
        if leaf.get("encoding") == "sparse":
            if leaf.get("index_dtype", "int32") != "int32":
                raise ValueError(
                    f"unsupported sparse index dtype: {leaf.get('index_dtype')!r}")
            # v2-only fields: presence is implied by encoding == "sparse"
            # (a cross-key guard the static checker cannot prove)
            i_start = leaf["indices_offset"]  # dfcheck: ignore[wire-version]
            indices = data[i_start:i_start + leaf["indices_nbytes"]]  # dfcheck: ignore[wire-version]
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


def tree_to_bytes(tree: Any) -> bytes:
    """Tree of host arrays -> single self-describing buffer."""
    return pack_bytes(serialize_tree(tree))


def tree_from_bytes(buf: bytes, like: Any) -> Any:
    """Single buffer -> a tree with the structure of ``like``."""
    return deserialize_tree(unpack_bytes(buf), like)
