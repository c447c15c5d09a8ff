"""Port of ``distriflow_tpu/checkpoint/sharded.py``: sharded checkpoints,
each rank writing only the shards it owns.

The on-disk layout is JAX's, field for field, so a checkpoint written by
either package restores in the other. ``save_dir/<version>/`` holds::

    meta.json       # leaf specs + full shard index (written by rank 0)
    shards.<p>.bin  # rank p's owned shards, packed back to back

A leaf is keyed by JAX's ``keystr`` of its path in the tree (``['params']
['w']``; dicts flatten in sorted key order, as JAX flattens them). A
tensor leaf is this rank's block of a global array, placed by a
:class:`~distriflow_tpu_torch.parallel.mesh.Placement` (a mesh axis a dim;
the ``placements`` tree beside the state); a leaf with no placement
(replicated tensors, numpy arrays, Python scalars) is whole on every rank.
Shard ownership and file offsets come from the placements alone: every
rank derives the same plan from the mesh's rank layout, the lowest rank
holding a shard writes it, and each byte of the state is written once
across the job. Dtype names are numpy's (``bfloat16`` for torch's bf16,
whose bits are written as they are).

Restore has JAX's two paths: **fast** when this rank's block under the
target placement is a saved shard (one read), **reshard** otherwise (the
global array is assembled from the shard records, then this rank's block
is cut), so checkpoints survive mesh-shape changes, onto fewer ranks too.

The commit is collective: every rank writes into one build directory,
then rank 0 publishes only if every rank wrote, and every rank raises on
any failure. The coordination (:class:`_Coordinator`) runs on the process
group's host store (``set``/``get``/``add``/``wait``/``delete_key``), never
on a process-group collective: a save may run on a background writer
thread, where a collective would race the training step's own.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distriflow_tpu_torch.checkpoint.store import (
    META_JSON,
    CheckpointStore,
    timestamp_version,
)

Slices = Tuple[Tuple[int, int], ...]

_COORD_TIMEOUT = timedelta(minutes=10)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class _Coordinator:
    """Host-side cross-rank coordination for collective saves, on the
    default process group's store (a key-value service over TCP or a
    file): barriers and write-once keys, safe from any thread."""

    def __init__(self):
        self.count = _world()
        self.index = _rank()
        self._store = None
        if self.count > 1:
            from torch.distributed.distributed_c10d import _get_default_store

            self._store = _get_default_store()

    @property
    def multi(self) -> bool:
        return self._store is not None

    def barrier(self, name: str) -> None:
        if self._store is None:
            return
        if self._store.add(f"{name}/arrived", 1) == self.count:
            self._store.set(f"{name}/open", "1")
        self._store.wait([f"{name}/open"], _COORD_TIMEOUT)

    def set(self, key: str, value: str) -> None:
        if self._store is not None:
            self._store.set(key, value)

    def get(self, key: str) -> str:
        self._store.wait([key], _COORD_TIMEOUT)
        return self._store.get(key).decode()

    def delete(self, key: str) -> None:
        """Best-effort recycling of a write-once key."""
        if self._store is not None:
            try:
                self._store.delete_key(key)
            except Exception:
                pass


def _shard_nbytes(slices: Slices, itemsize: int) -> int:
    return math.prod(stop - start for start, stop in slices) * itemsize if slices else itemsize


@dataclass
class _ShardRecord:
    slices: Slices
    process: int      # owning rank (writes the bytes)
    offset: int = 0   # byte offset within shards.<process>.bin
    nbytes: int = 0


@dataclass
class _LeafPlan:
    dtype: str
    shape: Tuple[int, ...]
    shards: List[_ShardRecord] = field(default_factory=list)


@dataclass
class ShardedSnapshot:
    """A host snapshot of this rank's owned shards and the global plan,
    taken on the caller's thread; :meth:`ShardedCheckpointStore.save` on
    it is pure file I/O, so the live tensors may change meanwhile."""

    plan: Dict[str, _LeafPlan]
    payload: List[Tuple[int, bytes]]  # (offset, shard bytes) for this rank
    extra_meta: Optional[Dict[str, Any]] = None


# -- trees ------------------------------------------------------------------


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in JAX's flatten order: dict keys sorted,
    ``['key']`` for a dict entry, ``[i]`` for a list or tuple entry;
    ``None`` holds no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _rebuild(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(tree))
    if tree is None:
        return None
    return leaves[prefix]


def _placement_map(placements: Any) -> Dict[str, Any]:
    from distriflow_tpu_torch.parallel.mesh import Placement

    if placements is None:
        return {}
    return {k: v for k, v in _flatten(placements) if isinstance(v, Placement)}


# -- dtypes and bytes -------------------------------------------------------


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return "bfloat16" if x.dtype == torch.bfloat16 else str(x.dtype).split(".")[-1]
    name = np.asarray(x).dtype.name
    return "bool" if name == "bool_" else name


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _host_bytes(x: Any) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _from_bytes(buf: bytes, name: str, shape) -> Any:
    """Host values of a shard: a CPU tensor for bfloat16 (numpy has no
    bfloat16), else a numpy array."""
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


# -- the plan ---------------------------------------------------------------


def _rank_coords(mesh) -> Dict[int, Dict[str, int]]:
    """Every rank's coordinate on each mesh axis."""
    ranks = mesh.mesh
    out = {}
    for pos in np.ndindex(*ranks.shape):
        out[int(ranks[pos])] = dict(zip(mesh.mesh_dim_names, pos))
    return out


def _global_shape(local_shape, placement) -> Tuple[int, ...]:
    from distriflow_tpu_torch.parallel.mesh import axis_size

    shape = list(local_shape)
    if placement is not None:
        for dim, ax in enumerate(placement.spec):
            if ax is not None:
                shape[dim] *= axis_size(placement.mesh, ax)
    return tuple(shape)


def _block_of(coords: Dict[str, int], shape, placement) -> Slices:
    """The block of a global ``shape`` array a rank at ``coords`` holds."""
    from distriflow_tpu_torch.parallel.mesh import axis_size

    out = []
    for dim, n in enumerate(shape):
        ax = placement.spec[dim] if placement is not None and dim < len(placement.spec) else None
        if ax is None:
            out.append((0, n))
        else:
            size = n // axis_size(placement.mesh, ax)
            out.append((coords[ax] * size, (coords[ax] + 1) * size))
    return tuple(out)


def _plan_leaf(x: Any, placement) -> _LeafPlan:
    """Global shard plan of one leaf: each distinct block, owned by the
    lowest rank holding it (rank 0 for a leaf with no placement)."""
    name = _dtype_name(x)
    local = tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))
    shape = _global_shape(local, placement)
    plan = _LeafPlan(dtype=name, shape=shape)
    if placement is None:
        slices: Slices = tuple((0, d) for d in shape)
        plan.shards.append(_ShardRecord(slices, 0, nbytes=_shard_nbytes(slices, _itemsize(name))))
        return plan
    owners: Dict[Slices, int] = {}
    for r, coords in _rank_coords(placement.mesh).items():
        s = _block_of(coords, shape, placement)
        owners[s] = min(owners.get(s, r), r)
    for s in sorted(owners):
        plan.shards.append(_ShardRecord(s, owners[s], nbytes=_shard_nbytes(s, _itemsize(name))))
    return plan


class ShardedCheckpointStore(CheckpointStore):
    """Directory-per-version checkpoints, one shard file a rank. Every
    rank constructs the store on the same directory; a store owns it, so
    rank 0 clears leftover ``.building-*`` directories of a crashed job."""

    def __init__(self, save_dir: str, max_to_keep: Optional[int] = None):
        super().__init__(save_dir, max_to_keep)
        self._seq = 0  # a per-save nonce for the coordination keys
        if _rank() == 0:
            for name in os.listdir(save_dir):
                if name.startswith(".building-"):
                    shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)

    # -- write ------------------------------------------------------------

    def snapshot(self, tree: Any, extra_meta: Optional[Dict[str, Any]] = None,
                 placements: Any = None) -> ShardedSnapshot:
        """Host copies of this rank's owned shards of ``tree`` (each
        tensor this rank's block, as ``placements`` places it) and the
        global plan."""
        me, world = _rank(), _world()
        places = _placement_map(placements)
        plan: Dict[str, _LeafPlan] = {}
        payload: List[Tuple[int, bytes]] = []
        offsets = [0] * world
        for key, leaf in _flatten(tree):
            leaf_plan = _plan_leaf(leaf, places.get(key))
            for rec in leaf_plan.shards:
                rec.offset = offsets[rec.process]
                offsets[rec.process] += rec.nbytes
                if rec.process == me:
                    payload.append((rec.offset, _host_bytes(leaf)))
            plan[key] = leaf_plan
        return ShardedSnapshot(plan=plan, payload=payload, extra_meta=extra_meta)

    def save(self, tree: Any, version: Optional[str] = None,
             extra_meta: Optional[Dict[str, Any]] = None, placements: Any = None) -> str:
        """Write ``tree`` (or a :class:`ShardedSnapshot`) as a new version.
        Every rank must call it with the same version."""
        snap = tree if isinstance(tree, ShardedSnapshot) else self.snapshot(
            tree, extra_meta, placements)
        if extra_meta is not None:
            snap.extra_meta = extra_meta
        version = version if version is not None else timestamp_version()
        coord = _Coordinator()
        self._seq += 1
        # the keys are write-once: the per-store sequence number (the same
        # on every rank: saves are collective and ordered) keeps re-saves
        # of one version apart
        tag = f"df-ckpt/{self.save_dir}/{version}/{self._seq}"
        build_dir = os.path.join(self.save_dir, f".building-{version}")
        if coord.index == 0:
            shutil.rmtree(build_dir, ignore_errors=True)
            os.makedirs(build_dir)
        coord.barrier(f"{tag}/prepare")
        err: Optional[BaseException] = None
        try:
            self._write_shards(build_dir, snap)
        except BaseException as e:
            err = e
        coord.set(f"{tag}/status/{coord.index}", "fail" if err else "ok")
        coord.barrier(f"{tag}/written")
        if not coord.multi:
            if err is not None:
                shutil.rmtree(build_dir, ignore_errors=True)
                raise err
            self._publish_dir(build_dir, version)
            return version
        # rank 0 publishes only if every rank wrote; every rank raises on a
        # failure anywhere (a local swallow would leave peers on a torn
        # version)
        if coord.index == 0:
            all_ok = False
            try:
                all_ok = err is None and all(
                    coord.get(f"{tag}/status/{p}") == "ok" for p in range(1, coord.count))
                if all_ok:
                    self._publish_dir(build_dir, version)
            except BaseException as e:
                # the verdict must reach the peers whatever failed here
                all_ok = False
                err = err if err is not None else e
            coord.set(f"{tag}/commit", "ok" if all_ok else "fail")
            if not all_ok:
                shutil.rmtree(build_dir, ignore_errors=True)
            committed = all_ok
            for p in range(1, coord.count):  # every peer has read the verdict
                coord.get(f"{tag}/done/{p}")
            for p in range(coord.count):
                coord.delete(f"{tag}/status/{p}")
            for p in range(1, coord.count):
                coord.delete(f"{tag}/done/{p}")
            coord.delete(f"{tag}/commit")
        else:
            committed = coord.get(f"{tag}/commit") == "ok"
            coord.set(f"{tag}/done/{coord.index}", "1")
        if not committed:
            if err is not None:
                raise err
            raise RuntimeError(f"sharded checkpoint {version} aborted: a peer process "
                               "failed to write its shards")
        return version

    def _write_shards(self, build_dir: str, snap: ShardedSnapshot) -> None:
        with open(os.path.join(build_dir, f"shards.{_rank()}.bin"), "wb") as f:
            for offset, data in snap.payload:
                assert f.tell() == offset, (f.tell(), offset)
                f.write(data)
        if _rank() == 0:
            meta = {
                "sharded": True,
                "format": 1,
                "processes": _world(),
                "leaves": {
                    key: {
                        "dtype": p.dtype,
                        "shape": list(p.shape),
                        "shards": [{"slices": [list(se) for se in r.slices],
                                    "process": r.process, "offset": r.offset,
                                    "nbytes": r.nbytes} for r in p.shards],
                    }
                    for key, p in snap.plan.items()
                },
            }
            if snap.extra_meta:
                meta["extra"] = snap.extra_meta
            with open(os.path.join(build_dir, META_JSON), "w") as f:
                json.dump(meta, f)

    # -- read -------------------------------------------------------------

    def load(self, version: str, like: Any, placements: Any = None) -> Any:
        """Load a version into the structure of ``like``: each tensor leaf
        placed by ``placements`` comes back as this rank's block (a CPU
        tensor), every other leaf whole (a CPU tensor for a tensor or
        bfloat16 template, numpy otherwise, as JAX gives a host leaf)."""
        d = os.path.join(self.save_dir, version)
        with open(os.path.join(d, META_JSON)) as f:
            meta = json.load(f)
        if not meta.get("sharded"):
            return super().load(version, like)
        leaves_meta = meta["leaves"]
        places = _placement_map(placements)
        files: Dict[int, Any] = {}
        try:
            out = {}
            for key, template in _flatten(like):
                if key not in leaves_meta:
                    raise KeyError(f"checkpoint {version} missing leaf {key!r}")
                out[key] = self._load_leaf(d, files, leaves_meta[key], template,
                                           places.get(key), key)
            return _rebuild(like, out)
        finally:
            for f in files.values():
                f.close()

    def restore_latest(self, like: Any, placements: Any = None) -> Optional[Tuple[str, Any]]:
        """:meth:`load` of :meth:`last` (None for an empty store)."""
        version = self.last()
        if version is None:
            return None
        return version, self.load(version, like, placements)

    def _read(self, d: str, files: Dict[int, Any], rec: Dict[str, Any], name: str) -> Any:
        p = rec["process"]
        if p not in files:
            files[p] = open(os.path.join(d, f"shards.{p}.bin"), "rb")
        f = files[p]
        f.seek(rec["offset"])
        buf = f.read(rec["nbytes"])
        if len(buf) != rec["nbytes"]:
            raise IOError(f"short read in shards.{p}.bin at {rec['offset']}")
        return _from_bytes(buf, name, [stop - start for start, stop in rec["slices"]])

    def _load_leaf(self, d: str, files: Dict[int, Any], lm: Dict[str, Any], template: Any,
                   placement, key: str) -> Any:
        shape = tuple(lm["shape"])
        name = lm["dtype"]
        t_shape = (tuple(template.shape) if isinstance(template, torch.Tensor)
                   else tuple(np.shape(template)))
        if _global_shape(t_shape, placement) != shape:
            raise ValueError(f"shape mismatch at {key!r}: checkpoint {shape} vs template "
                             f"{_global_shape(t_shape, placement)}")
        records = {tuple(tuple(se) for se in r["slices"]): r for r in lm["shards"]}
        if placement is not None and isinstance(template, torch.Tensor):
            want = _block_of(_rank_coords(placement.mesh)[_rank()], shape, placement)
            if want in records:  # fast path: the same partitioning
                block = self._read(d, files, records[want], name)
            else:  # reshard: assemble the global array, cut this rank's block
                full = self._assemble(d, files, lm, name)
                block = full[tuple(slice(a, b) for a, b in want)]
            return _as_tensor(block)
        full = self._assemble(d, files, lm, name)
        return _as_tensor(full) if isinstance(template, torch.Tensor) else full

    def _assemble(self, d: str, files: Dict[int, Any], lm: Dict[str, Any], name: str) -> Any:
        shape = tuple(lm["shape"])
        out = (torch.empty(shape, dtype=torch.bfloat16) if name == "bfloat16"
               else np.empty(shape, dtype=np.dtype(name)))
        for rec in lm["shards"]:
            region = tuple(slice(start, stop) for start, stop in rec["slices"])
            out[region] = self._read(d, files, rec, name)
        return out


def _as_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return torch.from_numpy(np.ascontiguousarray(x).copy())
