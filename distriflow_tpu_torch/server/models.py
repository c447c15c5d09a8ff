"""Port of ``distriflow_tpu/server/models.py`` (imports rewritten):
server-side model wrappers, versioning + persistence, over the port's
``checkpoint/store.py`` (a checkpoint holds the model's own parameter
tree, in the port's layout).

Re-design of the reference's ``DistributedServerModel`` interface and its
three implementations (``src/server/models.ts``): the server model adds
``version``, ``setup()`` (load-latest-or-init resume), and ``save()`` on top
of the core model surface.

- :class:`DistributedServerInMemoryModel` — version token only, no disk
  (reference ``:63-75``; version = ms timestamp).
- :class:`DistributedServerCheckpointedModel` — versioned directory
  checkpoints with a ``current`` pointer via ``CheckpointStore`` (the
  TfModel+Dynamic disk impls collapsed into one: the packed flat format
  serves both, reference ``:77-267``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, runtime_checkable

from distriflow_tpu_torch.checkpoint import CheckpointStore
from distriflow_tpu_torch.checkpoint.store import timestamp_version as _timestamp_version
from distriflow_tpu_torch.models.base import DistributedModel

Params = Any


@runtime_checkable
class DistributedServerModel(Protocol):
    """Reference iface (``src/server/models.ts:38-51``)."""

    version: str

    def setup(self) -> None: ...

    def save(self) -> str: ...

    def get_params(self) -> Params: ...

    def set_params(self, params: Params) -> None: ...


def is_server_model(obj: Any) -> bool:
    """Type guard (reference ``models.ts:59-61``)."""
    return (
        hasattr(obj, "version")
        and callable(getattr(obj, "setup", None))
        and callable(getattr(obj, "save", None))
    )


class DistributedServerInMemoryModel:
    """Version-stamped wrapper with no persistence (reference ``models.ts:63-75``)."""

    def __init__(self, model: DistributedModel):
        self.model = model
        self.version = ""

    def setup(self) -> None:
        self.model.setup()
        self.version = _timestamp_version()

    def save(self) -> str:
        self.version = _timestamp_version()
        return self.version

    # delegate the model surface
    def fit(self, x, y):
        return self.model.fit(x, y)

    def update(self, grads) -> None:
        self.model.update(grads)

    def predict(self, x):
        return self.model.predict(x)

    def evaluate(self, x, y) -> List[float]:
        return self.model.evaluate(x, y)

    def get_params(self) -> Params:
        return self.model.get_params()

    def set_params(self, params: Params) -> None:
        self.model.set_params(params)

    @property
    def input_shape(self):
        return self.model.input_shape

    @property
    def output_shape(self):
        return self.model.output_shape


class DistributedServerCheckpointedModel(DistributedServerInMemoryModel):
    """Disk-backed server model: save-per-update + resume-latest.

    Reference ``DistributedServerTfModel`` semantics (``models.ts:77-150``):
    ``setup()`` loads the newest checkpoint if one exists, else initializes
    fresh; ``save()`` writes ``save_dir/<version>/`` and swaps ``current``.

    Crash-consistent recovery (beyond the reference, which persists ONLY
    params): when a server installs a ``manifest_provider``, every save
    also writes the provider's training-state manifest atomically inside
    the version dir, and ``setup()`` exposes the restored checkpoint's
    manifest as ``restored_manifest`` — a restarted server resumes the
    dataset cursor, version clock, and dedup keys in lockstep with the
    weights they were saved with (``docs/ROBUSTNESS.md`` §8).
    """

    def __init__(
        self,
        model: DistributedModel,
        save_dir: str,
        max_to_keep: Optional[int] = None,
    ):
        super().__init__(model)
        self.store = CheckpointStore(save_dir, max_to_keep)
        #: set by the owning server before setup(): () -> JSON-able dict
        self.manifest_provider: Optional[Callable[[], Dict[str, Any]]] = None
        #: manifest of the checkpoint setup() restored, None on fresh init
        self.restored_manifest: Optional[Dict[str, Any]] = None

    def setup(self) -> None:
        self.model.setup()
        restored = self.store.restore_latest(self.model.get_params())
        if restored is not None:
            self.version, params = restored
            self.model.set_params(params)
            self.restored_manifest = self.store.load_manifest(self.version)
        else:
            self.version = self.save()

    def save(self) -> str:
        self.version = _timestamp_version()
        spec_name = getattr(getattr(self.model, "spec", None), "name", None)
        manifest = self.manifest_provider() if self.manifest_provider else None
        self.store.save(
            self.model.get_params(),
            version=self.version,
            extra_meta={"spec_name": spec_name},
            manifest=manifest,
        )
        return self.version
