"""Port of ``distriflow_tpu/server``: the wire-training servers (async SGD,
gradient averaging) and the inference server."""

from distriflow_tpu_torch.server.abstract_server import AbstractServer, DistributedServerConfig
from distriflow_tpu_torch.server.async_server import AsynchronousSGDServer
from distriflow_tpu_torch.server.federated_server import FederatedServer
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.server.models import (
    DistributedServerCheckpointedModel,
    DistributedServerInMemoryModel,
    DistributedServerModel,
    is_server_model,
)
from distriflow_tpu_torch.server.quarantine import GateVerdict, GradientGate

__all__ = [
    "AbstractServer",
    "DistributedServerConfig",
    "AsynchronousSGDServer",
    "FederatedServer",
    "InferenceServer",
    "DistributedServerCheckpointedModel",
    "DistributedServerInMemoryModel",
    "DistributedServerModel",
    "GateVerdict",
    "GradientGate",
    "is_server_model",
]
