"""Port of ``distriflow_tpu/obs``: the telemetry core the transport,
server, client and fleet router call (registry, tracing, profiler, flight
recorder, ``ReportBuilder``, ``TelemetryCollector``, the windowed
``TimelineStore``, the ``HealthSentinel`` with its SLO bands and the
``FleetTable``, and the trace assembler). The JAX package's ``dump``,
``ledger`` and ``jax_hooks`` are not ported."""

from distriflow_tpu_torch.obs.collector import ReportBuilder, TelemetryCollector  # noqa: F401
from distriflow_tpu_torch.obs.health import (  # noqa: F401
    FleetTable,
    HealthSentinel,
    SLOBand,
    default_bands,
)
from distriflow_tpu_torch.obs.telemetry import (  # noqa: F401
    Telemetry,
    get_telemetry,
    set_telemetry,
)
from distriflow_tpu_torch.obs.timeline import (  # noqa: F401
    NOOP_TIMELINE,
    TIMELINE_FILENAME,
    TimelineStore,
    fit_slope,
    quantile_from_buckets,
)
from distriflow_tpu_torch.obs.trace_assembler import (  # noqa: F401
    Assembly,
    Round,
    assemble,
    assemble_dir,
)
