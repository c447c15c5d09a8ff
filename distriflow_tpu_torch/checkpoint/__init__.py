"""Port of ``distriflow_tpu/checkpoint``: the versioned tree store, the
sharded store (one shard file a rank, JAX's layout), the trainers' store
constructor and the model-level ``save_model``/``load_model``."""

from typing import Any, Optional

from distriflow_tpu_torch.checkpoint.sharded import ShardedCheckpointStore
from distriflow_tpu_torch.checkpoint.store import CheckpointStore


def save_model(store: CheckpointStore, model: Any, version: Optional[str] = None) -> str:
    """Checkpoint a DistributedModel's params, recording its spec name so
    :func:`load_model` can rebuild the architecture from the zoo registry."""
    spec_name = getattr(getattr(model, "spec", None), "name", None)
    return store.save(model.get_params(), version=version, extra_meta={"spec_name": spec_name})


def load_model(save_dir: str, spec: Any = None, version: Optional[str] = None,
               device: Any = None, **kw: Any):
    """Rebuild a SpecModel from a checkpoint directory.

    If ``spec`` is not given, the checkpoint's recorded spec name is
    resolved against the port's model zoo
    (:mod:`distriflow_tpu_torch.models.zoo`) and built on ``device``
    (``cuda`` by default, as every zoo factory; JAX has no device to name)
    — the analog of the reference loading a saved LayersModel topology
    (``src/server/models.ts:140-150``). ``kw`` go to the SpecModel."""
    from distriflow_tpu_torch.models import zoo
    from distriflow_tpu_torch.models.base import ModelSpec, SpecModel

    store = CheckpointStore(save_dir)
    version = version or store.last()
    if version is None:
        raise FileNotFoundError(f"no checkpoints under {save_dir}")
    if spec is None:
        name = store.meta(version).get("spec_name")
        factory = getattr(zoo, name, None) if name else None
        if factory is None:
            raise ValueError(
                f"checkpoint {version} has no resolvable spec name ({name!r}); "
                "pass spec= explicitly")
        spec = factory(device=device)
    if not isinstance(spec, ModelSpec):
        raise TypeError(f"spec must be a ModelSpec, got {type(spec)}")
    model = SpecModel(spec, **kw)
    model.setup()
    template = model.get_params()
    model.set_params(store.load(version, template))
    return model


def make_store(checkpoint_dir: Optional[str], max_checkpoints: Optional[int] = None,
               sharded: bool = False) -> Optional[CheckpointStore]:
    """The one trainer-side store constructor: None dir -> no store;
    ``sharded`` selects the per-shard store."""
    if checkpoint_dir is None:
        return None
    if sharded:
        return ShardedCheckpointStore(checkpoint_dir, max_checkpoints)
    return CheckpointStore(checkpoint_dir, max_checkpoints)


__all__ = ["CheckpointStore", "ShardedCheckpointStore", "save_model", "load_model",
           "make_store"]
