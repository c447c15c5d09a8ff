"""Port of ``distriflow_tpu/obs``: the telemetry core the transport,
server and client call (registry, tracing, profiler, flight recorder,
``FleetTable`` and ``ReportBuilder``)."""

from distriflow_tpu_torch.obs.collector import ReportBuilder  # noqa: F401
from distriflow_tpu_torch.obs.health import FleetTable  # noqa: F401
from distriflow_tpu_torch.obs.telemetry import (  # noqa: F401
    Telemetry,
    get_telemetry,
    set_telemetry,
)
