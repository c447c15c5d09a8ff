"""Port of ``distriflow_tpu/obs``: the telemetry core the transport,
server and client call (registry, tracing, profiler, flight recorder,
``FleetTable``, ``ReportBuilder``, ``TelemetryCollector`` and the no-op
timeline)."""

from distriflow_tpu_torch.obs.collector import ReportBuilder, TelemetryCollector  # noqa: F401
from distriflow_tpu_torch.obs.health import FleetTable  # noqa: F401
from distriflow_tpu_torch.obs.telemetry import (  # noqa: F401
    Telemetry,
    get_telemetry,
    set_telemetry,
)
