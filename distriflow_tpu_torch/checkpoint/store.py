"""Port of ``distriflow_tpu/checkpoint/store.py``: the versioned checkpoint
store with a ``current`` pointer.

Unchanged from the JAX package except that a tree's leaves are tensors
(copied to the host once per save) and a loaded tree lands on the CPU as
the template's leaf kinds; :func:`~distriflow_tpu_torch.utils.serialization.deserialize_tree`
says how.

The JAX module's description follows.

Re-design of the reference's server-side persistence
(``src/server/models.ts``): versioned directory checkpoints
``save_dir/<version>/`` written on model update, a ``current`` symlink
maintained via force-symlink semantics (``models.ts:17-30``), ``list``/
``last``/``load`` for resume (``:113-150``), and the packed flat binary
format (``flatSerialize``: one ``data.bin`` + ``meta.json`` with
shapes/dtypes/byteOffsets, ``:236-267``).

Kept: version = millisecond timestamp string by default, doubling as the
coherence token on the wire (reference behavior); ``setup()``-style resume =
load ``last()``. Extended: atomic writes (tmp + rename) so a crash mid-save
never corrupts ``current``, explicit step-based versions for trainers, and
whole-TrainState checkpoints (params + optimizer state + step), which the
reference cannot express.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

from distriflow_tpu_torch.utils.serialization import (
    SerializedArray,
    deserialize_tree,
    flat_deserialize,
    flat_serialize,
    host_tree,
    serialize_tree,
)

CURRENT = "current"
DATA_BIN = "data.bin"
META_JSON = "meta.json"
MANIFEST_JSON = "manifest.json"


_version_lock = threading.Lock()
_last_version = 0


def timestamp_version() -> str:
    """Millisecond timestamp version (reference ``Date.now()`` dirs),
    strictly monotonic within the process.

    The single source of the version-string format: it doubles as the wire
    coherence token AND the checkpoint directory name, so there must be
    exactly one producer. The reference's raw ``Date.now()`` collides when
    two aggregations land in the same millisecond — a collision corrupts
    staleness tracking (two distinct model states share a token) and reuses
    a checkpoint directory, so same-ms calls bump by one instead.
    """
    global _last_version
    with _version_lock:
        now = int(time.time() * 1000)
        if now <= _last_version:
            now = _last_version + 1
        _last_version = now
        return str(now)


_timestamp_version = timestamp_version  # internal alias


class CheckpointStore:
    """Directory-per-version checkpoints of arbitrary trees.

    ``max_to_keep`` bounds disk growth: after each publish, versions beyond
    the newest N are deleted (the reference keeps every update's checkpoint
    forever, ``server/models.ts:132-138`` — unbounded growth at one dir per
    step). ``None`` preserves the reference behavior.
    """

    def __init__(self, save_dir: str, max_to_keep: Optional[int] = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        os.makedirs(save_dir, exist_ok=True)

    # -- write ------------------------------------------------------------

    def save(
        self,
        tree: Any,
        version: Optional[str] = None,
        extra_meta: Optional[Dict[str, Any]] = None,
        manifest: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Write ``tree`` as a new version; returns the version string.

        Atomic: writes to a tmp dir then renames into place, then swaps the
        ``current`` symlink (force-symlink semantics, ``models.ts:17-30``).

        ``manifest`` is an optional JSON-able dict written as
        ``manifest.json`` inside the version directory BEFORE the publish
        rename — so the params and the manifest land (or don't) as one
        atomic unit. Servers persist their training-plane state this way
        (dataset cursor, version clock, dedup keys; see
        ``docs/ROBUSTNESS.md`` §8): a crash between two saves rolls both
        the weights and the bookkeeping back to the same consistent pair.
        """
        version = version if version is not None else _timestamp_version()
        blob, meta = flat_serialize(serialize_tree(host_tree(tree)))  # device -> host once
        if extra_meta:
            meta["extra"] = extra_meta
        tmp_dir = tempfile.mkdtemp(dir=self.save_dir, prefix=f".tmp-{version}-")
        try:
            with open(os.path.join(tmp_dir, DATA_BIN), "wb") as f:
                f.write(blob)
            with open(os.path.join(tmp_dir, META_JSON), "w") as f:
                json.dump(meta, f)
            if manifest is not None:
                with open(os.path.join(tmp_dir, MANIFEST_JSON), "w") as f:
                    json.dump(manifest, f)
            self._publish_dir(tmp_dir, version)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        return version

    def _publish_dir(self, src_dir: str, version: str) -> None:
        """Rename a fully-written directory into place and swap ``current``.

        On overwrite, the old version is moved aside first so readers never
        see a half-deleted directory; the rename-rename window is the only
        non-atomic moment and only exists when re-saving the SAME version
        string (never in normal timestamp/step flows).
        """
        final_dir = os.path.join(self.save_dir, version)
        if os.path.isdir(final_dir):
            # move the old version aside first so readers never see a
            # half-deleted directory (re-saving the same version string)
            self._trash(final_dir)
        os.rename(src_dir, final_dir)
        self._force_symlink(version)
        try:
            self._prune()
        except Exception as e:
            # pruning is best-effort housekeeping: the save IS published
            # (renamed + `current` swapped); a disk-pressure error here must
            # not report the whole save as failed — or, in the sharded
            # store's collective commit, abort every peer over a version
            # that is actually live. But say so: a persistently failing
            # prune means max_to_keep has silently stopped bounding disk.
            warnings.warn(
                f"checkpoint prune failed after publishing {version}: {e!r} "
                "(save succeeded; old versions may accumulate)",
                stacklevel=2,
            )

    def _trash(self, path: str) -> None:
        """Move a version directory aside then delete it, so readers never
        see a half-deleted directory."""
        trash_dir = tempfile.mkdtemp(dir=self.save_dir, prefix=".trash-")
        try:
            os.rename(path, os.path.join(trash_dir, os.path.basename(path)))
        except OSError:
            pass  # concurrent prune/delete: someone else got it
        finally:
            shutil.rmtree(trash_dir, ignore_errors=True)

    def _prune(self) -> None:
        """Delete versions beyond the newest ``max_to_keep`` (runs on the
        publishing process only — multi-host safe for the sharded store).

        Retention races with concurrent readers of *non-current* versions:
        a reader mid-``load`` on an old version string can lose files under
        it (the trash-then-delete move narrows but does not close the
        window). Readers should resolve via the ``current`` pointer — whose
        target prune never deletes — rather than pinning old version
        strings; pin an old version only with ``max_to_keep=None``.
        """
        if self.max_to_keep is None:
            return
        versions = self.list()
        current = self.last()
        for v in versions[: -self.max_to_keep]:
            if v == current:
                continue  # never delete the published pointer's target
            self._trash(os.path.join(self.save_dir, v))

    def _force_symlink(self, version: str) -> None:
        link = os.path.join(self.save_dir, CURRENT)
        # per-caller-unique staging name: concurrent publishers (federated
        # aggregation racing a drill/teardown save) must not collide on a
        # shared "current.tmp" — with one shared name, both can pass an
        # exists-check and the second symlink() raises FileExistsError
        tmp_link = f"{link}.tmp-{os.getpid()}-{threading.get_ident()}"
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(version, tmp_link)
        os.replace(tmp_link, link)  # atomic swap

    # -- read -------------------------------------------------------------

    def list(self) -> List[str]:
        """All version strings, sorted ascending (reference ``list``, ``models.ts:113-121``)."""
        out = []
        for name in os.listdir(self.save_dir):
            path = os.path.join(self.save_dir, name)
            if name == CURRENT or name.startswith(".") or name.startswith(CURRENT + "."):
                continue  # pointer, tmp/trash dirs, or a crashed staging link
            if os.path.isdir(path) and os.path.exists(os.path.join(path, META_JSON)):
                out.append(name)
        # numeric versions (timestamps, step counters) order numerically so
        # '10' > '9'; mixed/non-numeric names fall back to lexicographic
        return sorted(out, key=lambda v: (0, int(v), "") if v.isdigit() else (1, 0, v))

    def last(self) -> Optional[str]:
        """Latest version: the ``current`` pointer if valid, else max of list."""
        link = os.path.join(self.save_dir, CURRENT)
        if os.path.islink(link):
            target = os.readlink(link)
            if os.path.exists(os.path.join(self.save_dir, target, META_JSON)):
                return target
        versions = self.list()
        return versions[-1] if versions else None

    def load_serialized(self, version: str) -> Tuple[Dict[str, SerializedArray], Dict[str, Any]]:
        d = os.path.join(self.save_dir, version)
        with open(os.path.join(d, META_JSON)) as f:
            meta = json.load(f)
        with open(os.path.join(d, DATA_BIN), "rb") as f:
            blob = f.read()
        return flat_deserialize(blob, meta), meta

    def load(self, version: str, like: Any) -> Any:
        """Load a version into the tree structure of ``like``."""
        serialized, _ = self.load_serialized(version)
        return deserialize_tree(serialized, like)

    def restore_latest(self, like: Any) -> Optional[Tuple[str, Any]]:
        """Resume support (reference ``setup()`` loads ``last()``, ``models.ts:98-111``)."""
        version = self.last()
        if version is None:
            return None
        return version, self.load(version, like)

    def meta(self, version: str) -> Dict[str, Any]:
        with open(os.path.join(self.save_dir, version, META_JSON)) as f:
            return json.load(f).get("extra", {})

    def load_manifest(self, version: str) -> Optional[Dict[str, Any]]:
        """The training-state manifest saved with ``version``, or None when
        the checkpoint predates manifests (or none was supplied)."""
        path = os.path.join(self.save_dir, version, MANIFEST_JSON)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
