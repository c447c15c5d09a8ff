"""Port of ``distriflow_tpu/client``: the wire-training workers (async
SGD, gradient averaging) and the inference client."""

from distriflow_tpu_torch.client.abstract_client import (
    AbstractClient,
    DistributedClientConfig,
    resolve_client_id,
)
from distriflow_tpu_torch.client.async_client import AsynchronousSGDClient
from distriflow_tpu_torch.client.federated_client import FederatedClient
from distriflow_tpu_torch.client.inference_client import (
    InferenceClient,
    RequestRefused,
    RequestShed,
)

__all__ = [
    "AbstractClient",
    "DistributedClientConfig",
    "resolve_client_id",
    "AsynchronousSGDClient",
    "FederatedClient",
    "InferenceClient",
    "RequestRefused",
    "RequestShed",
]
