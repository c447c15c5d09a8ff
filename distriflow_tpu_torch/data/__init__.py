"""Port of ``distriflow_tpu/data``: batch dispatch with ack/requeue, the
host batch stream and device prefetch of the training loops, and the
streaming token dataset."""

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
from distriflow_tpu_torch.data.streaming import StreamingTokenDataset, write_token_file

__all__ = [
    "Batch",
    "DistributedDataset",
    "batch_to_data_msg",
    "sample_batch",
    "prefetch_to_device",
    "sampling_iterator",
    "to_uint8_wire",
    "StreamingTokenDataset",
    "write_token_file",
]
