"""Port of ``distriflow_tpu/train``: the single-device synchronous trainer,
async SGD with bounded staleness over in-process workers, federated
averaging on one device, and the chunked training loop with exact chunked
evaluation. The learning-rate schedules are their own module,
:mod:`distriflow_tpu_torch.train.schedules`, as in JAX."""

from distriflow_tpu_torch.train.async_sgd import AsyncSGDTrainer
from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer
from distriflow_tpu_torch.train.loop import ChunkedRunResult, evaluate_dataset, run_chunked
from distriflow_tpu_torch.train.sync import SyncTrainer, TrainState

__all__ = [
    "AsyncSGDTrainer",
    "ChunkedRunResult",
    "FederatedAveragingTrainer",
    "SyncTrainer",
    "TrainState",
    "run_chunked",
    "evaluate_dataset",
]
