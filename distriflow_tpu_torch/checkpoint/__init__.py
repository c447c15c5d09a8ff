"""Port of ``distriflow_tpu/checkpoint``: the versioned tree store and the
trainers' store constructor. The multi-host sharded store and the
model-level ``save_model``/``load_model`` wait for their slices."""

from typing import Optional

from distriflow_tpu_torch.checkpoint.store import CheckpointStore


def make_store(checkpoint_dir: Optional[str], max_checkpoints: Optional[int] = None,
               sharded: bool = False) -> Optional[CheckpointStore]:
    """The one trainer-side store constructor: None dir -> no store.
    ``sharded`` (the multi-host per-shard store) is not ported yet."""
    if sharded:
        raise NotImplementedError("sharded checkpoints are not ported yet")
    if checkpoint_dir is None:
        return None
    return CheckpointStore(checkpoint_dir, max_checkpoints)


__all__ = ["CheckpointStore", "make_store"]
