"""Request-scoped tracing (Dapper-style trace and span propagation).

Counterpart of ``paddle_tpu/observability/tracing.py``, with the same
wire dict, so a trace minted by either package's client is read by
either server. A :class:`SpanContext` is minted at the edge
(``serving.Client``, or any caller through :func:`maybe_trace` /
:func:`new_trace`), carried in the wire frame beside the request as a
``"trace"`` dict, and threaded through admission, queue, pad, execute,
prefill and decode. Every recorded span lands in the profiler's span
table (``paddle_tpu_torch.profiler``), so ``tools/timeline.py`` renders
one Chrome/Perfetto trace of server stages and executor spans.

Sampling (``FLAGS_trace_sample_rate``) happens once, at the edge: an
untraced request pays one ``random()`` draw at the client and one
``None`` check per server stage. Traced spans record even while the
profiler is off; ``profiler.reset_profiler()`` clears them, and the
span table's cap and drop counter bound their memory.
"""
import random
import threading
import time
import uuid
from contextlib import contextmanager

from .. import profiler as _prof
from ..flags import flag as _flag
from .metrics import default_registry

_tls = threading.local()

_TRACES_SAMPLED = default_registry().counter(
    "telemetry_traces_sampled_total",
    "trace contexts minted at the client edge (FLAGS_trace_sample_rate)")

default_registry().register_collector(
    lambda: [{"name": "telemetry_spans_dropped_total",
              "kind": "counter",
              "help": "spans lost to the profiler span-table cap "
                      "(process-lifetime total; reset_profiler only "
                      "zeroes the session count, keeping this "
                      "monotonic)",
              "labels": (),
              "samples": [((), _prof.spans_dropped_total())]}],
    families=[{"name": "telemetry_spans_dropped_total",
               "kind": "counter",
               "help": "spans lost to the profiler span-table cap "
                       "(process-lifetime, monotonic)",
               "labels": ()}])


class SpanContext:
    """(trace_id, span_id, parent_id) triple. ``span_id`` names THIS
    span; children are minted with :meth:`child`."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id=None, parent_id=""):
        self.trace_id = trace_id
        self.span_id = span_id if span_id is not None else _new_id()
        self.parent_id = parent_id

    def child(self):
        return SpanContext(self.trace_id, _new_id(), self.span_id)

    def __repr__(self):
        return (f"SpanContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_id or 'root'})")


def _new_id():
    return uuid.uuid4().hex[:16]


def new_trace():
    """Unconditionally mint a root span context (the explicit API —
    sampling is the caller's business)."""
    _TRACES_SAMPLED.inc()
    return SpanContext(_new_id())


def maybe_trace():
    """The edge sampler: the ambient context's child if one is active,
    else a fresh root with probability ``FLAGS_trace_sample_rate``,
    else None. One random() draw on the untraced path."""
    ctx = current()
    if ctx is not None:
        return ctx.child()
    if random.random() < _flag("trace_sample_rate"):
        return new_trace()
    return None


def current():
    """The ambient span context of this thread (None when untraced)."""
    return getattr(_tls, "ctx", None)


@contextmanager
def ambient(ctx):
    """Install ``ctx`` as this thread's ambient context for the block
    (``Request._init_lifecycle`` picks it up so spans recorded by the
    batcher threads parent correctly). ``ctx=None`` is a no-op."""
    if ctx is None:
        yield None
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def record_span(name, start_s, end_s, ctx):
    """Record a completed span AS ``ctx`` (trace/span/parent ids ride
    into the profiler span table). No-op when ``ctx`` is None."""
    if ctx is None:
        return
    _prof.record_span(name, start_s, end_s,
                      trace=(ctx.trace_id, ctx.span_id, ctx.parent_id))


def record_child(name, start_s, end_s, parent):
    """Record a completed span as a fresh CHILD of ``parent``; returns
    the child context (None when untraced)."""
    if parent is None:
        return None
    ctx = parent.child()
    record_span(name, start_s, end_s, ctx)
    return ctx


@contextmanager
def span(name, parent=None):
    """Span context manager: times the block and records it as a child
    of ``parent`` (default: the ambient context), installing the child
    as ambient inside the block so nested spans chain."""
    parent = parent if parent is not None else current()
    if parent is None:
        yield None
        return
    ctx = parent.child()
    t0 = time.perf_counter()
    with ambient(ctx):
        try:
            yield ctx
        finally:
            record_span(name, t0, time.perf_counter(), ctx)


# -- wire representation (inside the typed wire value universe) ----------

def to_wire(ctx):
    """``{"tid", "sid"}`` dict for the wire frame (None passthrough)."""
    if ctx is None:
        return None
    return {"tid": ctx.trace_id, "sid": ctx.span_id}


def from_wire(d):
    """SpanContext from a wire ``"trace"`` dict (None / malformed ->
    None; a hostile frame must never raise here)."""
    if not isinstance(d, dict):
        return None
    tid, sid = d.get("tid"), d.get("sid")
    if not (isinstance(tid, str) and isinstance(sid, str)):
        return None
    return SpanContext(tid[:64], sid[:64])
