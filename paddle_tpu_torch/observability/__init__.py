"""The port's telemetry substrate (counterpart of
``paddle_tpu/observability/``, with its names, label sets and payloads):

- :mod:`metrics`: ``MetricsRegistry`` of labeled counters, gauges and
  histograms with Prometheus text exposition; ``ServingStats``,
  ``Executor.cache_stats()`` and the pass pipeline report into it.
  Scraped in-process (:func:`render_metrics`) or by the serving
  ``"metrics"`` wire op.
- :mod:`tracing`: trace and span contexts minted at the client, carried
  in the wire frame and threaded through queue, pad, execute, prefill
  and decode into the profiler's span table.
- :mod:`utilization`: live MFU / HBM-bandwidth gauges from estimated
  step costs and device-timed executions (CUDA event pairs), against
  the card's peak tables.
- :mod:`recorder`: the flight recorder, a bounded ring of structured
  events, dumped by the ``"debug_dump"`` wire op or to a file.
- :mod:`profiling`: the per-op cost estimate, ``FLAGS_profile_ops``
  measured op-by-op replays and the HBM live-set memory profile.
- :mod:`slo`: the rule-driven SLO monitor.
- :mod:`goodput`: the training goodput ledger.
- :mod:`inputstall`: the input-pipeline stall tracker.

The collective-traffic ledger and the sharding audit (``comms``,
``sharding``) are not ported.
"""
from .goodput import CATEGORIES, GoodputLedger  # noqa: F401
from .inputstall import StallTracker  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_BOUNDS_MS, Family, MetricsRegistry, UNIT_SUFFIXES,
    default_registry, render_metrics,
)
from .profiling import (  # noqa: F401
    format_table, last_op_profile, measure_op_times, memory_profile,
    profile_program,
)
from .recorder import FlightRecorder, flight_recorder  # noqa: F401
from .slo import SloMonitor, SloRule, default_server_rules  # noqa: F401
from .tracing import (  # noqa: F401
    SpanContext, ambient, current, from_wire, maybe_trace, new_trace,
    record_child, record_span, span, to_wire,
)
from .utilization import (  # noqa: F401
    dcn_peak, hbm_peak, ici_peak, observe_execution, peak_flops,
    set_peaks,
)
