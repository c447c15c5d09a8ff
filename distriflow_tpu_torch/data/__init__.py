"""Port of ``distriflow_tpu/data``: batch dispatch with ack/requeue, the
host batch stream and device prefetch of the training loops (the
streaming token dataset waits for its slice)."""

from distriflow_tpu_torch.data.dataset import (
    Batch,
    DistributedDataset,
    batch_to_data_msg,
    sample_batch,
)
from distriflow_tpu_torch.data.prefetch import (
    prefetch_to_device,
    sampling_iterator,
    to_uint8_wire,
)

__all__ = [
    "Batch",
    "DistributedDataset",
    "batch_to_data_msg",
    "sample_batch",
    "prefetch_to_device",
    "sampling_iterator",
    "to_uint8_wire",
]
