"""Telemetry (PyTorch port of `lightgbm_tpu/observability/`): the
metrics registry, the structured JSONL event log, the flight recorder,
the async host-I/O writer with its SIGTERM flush, the device-memory
sampler, the analytic cost model with its roofline, request tracing
with SLO burn rates, and the Prometheus exposition.

Knobs (`train` parameters, as in the JAX package):
  * `metrics_dir=` — JSONL event log, flight recorder dumps
  * `profile_dir=` — a torch.profiler Chrome trace of the run
  * `metrics_port=` — Prometheus `GET /metrics` listener
  * `roofline=` — analytic flop/byte accounting + per-phase measured MFU
  * `LIGHTGBM_TPU_TIMETAG=1` — host phase timers (utils/timer.py)

Eager torch has no recompiles, so the JAX package's `RecompileDetector`
and compile cache have no counterpart: the cost model's call sites
report analytic counts instead of the compiler's (costmodel.py).
"""

from .costmodel import (backend_peaks, enable_cost_model,
                        global_cost_model, roofline)
from .events import (EventLogger, emit_event, emit_event_sync,
                     get_event_logger, set_event_logger)
from .flightrec import (FlightRecorder, dump_flight_record,
                        flight_file_path, flight_recorder)
from .hostio import (AsyncWriter, clear_preemption_hook, flush_host_io,
                     install_sigterm_flush, set_preemption_hook)
from .prom import (parse_prometheus_text, render_prometheus,
                   start_metrics_http)
from .registry import (LatencyWindow, MetricsRegistry, global_registry,
                       process_rank)
from .tracing import (SloTracker, SpanAssembler, TraceContext, make_span,
                      new_span_id, new_trace_id)
from .watchdog import sample_device_memory, update_memory_gauges

__all__ = [
    "AsyncWriter",
    "backend_peaks", "enable_cost_model", "global_cost_model", "roofline",
    "EventLogger", "emit_event", "emit_event_sync", "get_event_logger",
    "set_event_logger",
    "FlightRecorder", "dump_flight_record", "flight_file_path",
    "flight_recorder",
    "flush_host_io", "install_sigterm_flush",
    "set_preemption_hook", "clear_preemption_hook",
    "LatencyWindow", "MetricsRegistry", "global_registry", "process_rank",
    "parse_prometheus_text", "render_prometheus", "start_metrics_http",
    "SloTracker", "SpanAssembler", "TraceContext", "make_span",
    "new_span_id", "new_trace_id",
    "sample_device_memory", "update_memory_gauges",
]
