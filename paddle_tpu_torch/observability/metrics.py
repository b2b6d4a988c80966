"""MetricsRegistry: the one telemetry substrate the port reports into.

Counterpart of ``paddle_tpu/observability/metrics.py``: labeled
counters, gauges and histograms with Prometheus text-format exposition,
byte for byte the JAX package's, so one scraper, ``tools/lint_metrics.py``
and the README metric catalog hold for both packages.

- **cheap bumps**: one small lock per family, no allocation after the
  first observation of a label set.
- **bounded label cardinality**: each family holds at most
  ``max_series`` label sets; the overflow folds into a reserved
  ``"_other"`` series and bumps ``telemetry_series_dropped_total``.
- **two report paths**: native instruments for new subsystems, and
  scrape-time **collectors** for existing stat sinks (``ServingStats``,
  ``Executor.cache_stats()``), which keep their Python payloads.
  Collectors declare their families up front, so the catalog sees every
  name without traffic.

Names are snake_case, unique and unit-suffixed with one of
:data:`UNIT_SUFFIXES`.
"""
import re
import threading
import weakref

# closed set of accepted metric-name unit suffixes (lint-enforced):
# _total  monotonic counters          _ms     millisecond durations
# _bytes  byte sizes                  _ratio  0..1 utilizations
# _state  small state enums (0/1/2)   _count  gauge-valued counts
# _value  dimensionless instantaneous readings (loss, norms)
UNIT_SUFFIXES = ("_total", "_ms", "_bytes", "_ratio", "_state", "_count",
                 "_value")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# log-spaced default histogram bounds in milliseconds (last bucket +inf)
DEFAULT_BOUNDS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                     100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_OTHER = "_other"      # reserved label value for cardinality overflow


def _check_name(name):
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} is not snake_case")
    if not name.endswith(UNIT_SUFFIXES):
        raise ValueError(
            f"metric name {name!r} lacks a unit suffix "
            f"({', '.join(UNIT_SUFFIXES)})")
    return name


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt(v):
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    if f != f:                      # NaN: Prometheus's "no value"
        return "NaN"
    if f == float("-inf"):
        return "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


class Family:
    """One metric family (a name + label names + kind); holds the
    per-label-set series. Instruments are label-positional:
    ``fam.inc(1, labels=("queue",))`` — a tuple matching
    ``label_names``."""

    __slots__ = ("name", "kind", "help", "label_names", "bounds",
                 "max_series", "_series", "_lock", "_registry",
                 "dropped")

    def __init__(self, registry, name, kind, help, label_names=(),
                 bounds=None, max_series=64):
        self.name = _check_name(name)
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self.bounds = tuple(float(b) for b in bounds) \
            if bounds is not None else None
        self.max_series = int(max_series)
        self._series = {}
        self._lock = threading.Lock()
        self._registry = registry
        # observations folded into _other by the cardinality cap;
        # per-family under the family lock (the registry sums at
        # render time — a cross-family shared counter would need its
        # own lock on every fold)
        self.dropped = 0

    def _slot(self, labels):
        """The mutable series cell for ``labels`` (created on first
        use; overflow past ``max_series`` folds into the ``_other``
        set)."""
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {labels!r}")
        cell = self._series.get(labels)
        if cell is None:
            if len(self._series) >= self.max_series:
                self.dropped += 1
                labels = (_OTHER,) * len(self.label_names)
                cell = self._series.get(labels)
                if cell is not None:
                    return cell
            if self.kind == "histogram":
                cell = [[0] * (len(self.bounds) + 1), 0, 0.0]
            else:
                cell = [0.0]
            self._series[labels] = cell
        return cell

    # -- instruments ------------------------------------------------------
    def inc(self, n=1, labels=()):
        with self._lock:
            self._slot(tuple(labels))[0] += n

    def set(self, value, labels=()):
        with self._lock:
            self._slot(tuple(labels))[0] = float(value)

    def observe(self, value, labels=()):
        v = float(value)
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            cell = self._slot(tuple(labels))
            cell[0][idx] += 1
            cell[1] += 1
            cell[2] += v

    def value(self, labels=()):
        """Current value (counter/gauge) or (counts, count, sum)
        (histogram) of one series; 0/empty when never touched."""
        with self._lock:
            cell = self._series.get(tuple(labels))
            if cell is None:
                return 0.0 if self.kind != "histogram" else ([], 0, 0.0)
            if self.kind == "histogram":
                return (list(cell[0]), cell[1], cell[2])
            return cell[0]

    def samples(self):
        """Snapshot: [(label_values, payload)] — payload is a number
        for counter/gauge, ``{"buckets": [(le, cumulative)], "count",
        "sum"}`` for histograms (buckets CUMULATIVE, prometheus
        style)."""
        with self._lock:
            snap = [(k, (list(v[0]), v[1], v[2])
                     if self.kind == "histogram" else v[0])
                    for k, v in self._series.items()]
        if self.kind != "histogram":
            return snap
        out = []
        for k, (counts, count, total) in snap:
            cum, buckets = 0, []
            for le, c in zip(self.bounds + (float("inf"),), counts):
                cum += c
                buckets.append((le, cum))
            out.append((k, {"buckets": buckets, "count": count,
                            "sum": total}))
        return out


class MetricsRegistry:
    """Families + collectors with one text-format renderer."""

    def __init__(self):
        self._families = {}
        self._collectors = []       # (fn, declared family dicts)
        self._declared = {}         # name -> meta (collector families)
        self._lock = threading.Lock()

    # -- registration -----------------------------------------------------
    def _family(self, name, kind, help, labels, bounds=None,
                max_series=64):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}")
                return fam
            if name in self._declared:
                raise ValueError(f"metric {name!r} already declared by "
                                 f"a collector")
            fam = Family(self, name, kind, help, labels, bounds=bounds,
                         max_series=max_series)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=(), max_series=64):
        return self._family(name, "counter", help, labels,
                            max_series=max_series)

    def gauge(self, name, help="", labels=(), max_series=64):
        return self._family(name, "gauge", help, labels,
                            max_series=max_series)

    def histogram(self, name, help="", labels=(),
                  bounds=DEFAULT_BOUNDS_MS, max_series=64):
        return self._family(name, "histogram", help, labels,
                            bounds=bounds, max_series=max_series)

    def register_collector(self, fn, families):
        """Register a scrape-time collector. ``fn()`` returns a list of
        family dicts ``{"name", "kind", "help", "labels", "samples"}``
        (samples as :meth:`Family.samples` produces), plus an optional
        cumulative ``"dropped"`` count of series the collector folded
        away under its own cardinality cap — it feeds
        ``telemetry_series_dropped_total`` and must be monotone.
        ``families`` declares, up front, every family the collector may
        emit — the catalog/lint surface."""
        with self._lock:
            for meta in families:
                name = _check_name(meta["name"])
                if name in self._families or name in self._declared:
                    raise ValueError(f"metric {name!r} already "
                                     f"registered")
                self._declared[name] = dict(meta)
            self._collectors.append(fn)

    def catalog(self):
        """{name: {"kind", "help", "labels"}} across native families
        AND collector-declared ones — every name the exposition can
        ever emit (plus the registry's own drop counter)."""
        with self._lock:
            out = {n: {"kind": f.kind, "help": f.help,
                       "labels": f.label_names}
                   for n, f in self._families.items()}
            for n, meta in self._declared.items():
                out[n] = {"kind": meta.get("kind", "counter"),
                          "help": meta.get("help", ""),
                          "labels": tuple(meta.get("labels", ()))}
        out["telemetry_series_dropped_total"] = {
            "kind": "counter",
            "help": "observations folded into an _other series by the "
                    "per-family label-cardinality cap", "labels": ()}
        return out

    def collect(self):
        """Structured snapshot of every family's CURRENT samples —
        native instruments AND collector-emitted ones::

            {name: {"kind", "help", "labels", "samples"}}

        with ``samples`` in :meth:`Family.samples` shape. This is the
        programmatic scrape the SLO monitor evaluates rules against and
        the fleet-metrics aggregation re-exposes; :meth:`render` is the
        same data as Prometheus text."""
        with self._lock:
            fams = list(self._families.items())
            collectors = list(self._collectors)
            declared = dict(self._declared)
        out = {}
        for name, fam in fams:
            out[name] = {"kind": fam.kind, "help": fam.help,
                         "labels": fam.label_names,
                         "samples": fam.samples()}
        for fn in collectors:
            try:
                emitted = fn()
            except Exception:  # noqa: BLE001 — one sink never kills it
                continue
            for f in emitted:
                meta = declared.get(f["name"], {})
                out[f["name"]] = {
                    "kind": f.get("kind", meta.get("kind", "counter")),
                    "help": f.get("help", meta.get("help", "")),
                    "labels": tuple(f.get("labels",
                                          meta.get("labels", ()))),
                    "samples": list(f.get("samples", ())),
                }
        return out

    # -- exposition -------------------------------------------------------
    @staticmethod
    def _labelstr(names, values):
        if not names:
            return ""
        inner = ",".join(f'{n}="{_escape_label(v)}"'
                         for n, v in zip(names, values))
        return "{" + inner + "}"

    @staticmethod
    def _render_family(lines, name, kind, help, label_names, samples):
        lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for values, payload in samples:
            if kind == "histogram":
                for le, cum in payload["buckets"]:
                    ls = MetricsRegistry._labelstr(
                        tuple(label_names) + ("le",),
                        tuple(values) + (_fmt(le),))
                    lines.append(f"{name}_bucket{ls} {cum}")
                ls = MetricsRegistry._labelstr(label_names, values)
                lines.append(f"{name}_sum{ls} {_fmt(payload['sum'])}")
                lines.append(f"{name}_count{ls} {payload['count']}")
            else:
                ls = MetricsRegistry._labelstr(label_names, values)
                lines.append(f"{name}{ls} {_fmt(payload)}")

    def render(self):
        """Prometheus text exposition (format 0.0.4) of every native
        family and every collector's current samples."""
        with self._lock:
            fams = sorted(self._families.items())
            collectors = list(self._collectors)
        dropped = sum(f.dropped for _n, f in fams)
        lines = []
        for name, fam in fams:
            self._render_family(lines, name, fam.kind, fam.help,
                                fam.label_names, fam.samples())
        for fn in collectors:
            try:
                emitted = fn()
            except Exception:  # noqa: BLE001 — one sink never kills scrape
                continue
            for f in emitted:
                # collectors report their own cumulative series-cap
                # folds (e.g. the breaker collector's endpoint cap)
                dropped += int(f.get("dropped", 0))
                self._render_family(lines, f["name"],
                                    f.get("kind", "counter"),
                                    f.get("help", ""),
                                    tuple(f.get("labels", ())),
                                    f.get("samples", ()))
        self._render_family(
            lines, "telemetry_series_dropped_total", "counter",
            "observations folded into an _other series by the "
            "per-family label-cardinality cap", (),
            [((), dropped)])
        return "\n".join(lines) + "\n"


class InstanceAggregator:
    """The WeakSet-of-live-instances + finalizer-banked-retired-totals
    skeleton shared by per-instance sink bridges (``ServingStats``,
    ``Executor`` caches). Exported ``*_total`` counters must stay
    monotonic across instance churn — a scraped counter falling to 0
    when a server or executor object dies reads as a counter reset and
    fabricates rate() spikes — so :meth:`track` registers a finalizer
    that folds the dying instance's final counter values into a banked
    total, and :meth:`totals` sums live instances plus the bank.

    Only the scalar-counter banking lives here; site-specific
    retirement (histogram bucket merges, cache clearing) rides the same
    finalizer via ``extra_retire``."""

    def __init__(self, counter_keys):
        self._instances = weakref.WeakSet()
        self._lock = threading.Lock()
        self._retired = {k: 0 for k in counter_keys}

    def track(self, instance, final_counts_fn, extra_retire=None):
        """Track a live instance. ``final_counts_fn()`` must close over
        the instance's stat containers (NOT the instance itself — the
        finalizer must not keep it alive) and return its final
        ``{key: count}``. ``extra_retire()``, if given, runs after the
        bank fold."""
        self._instances.add(instance)
        weakref.finalize(instance, self._retire, final_counts_fn,
                         extra_retire)

    def _retire(self, final_counts_fn, extra_retire):
        counts = final_counts_fn()
        with self._lock:
            for k in self._retired:
                self._retired[k] += counts.get(k, 0)
        if extra_retire is not None:
            extra_retire()

    def live(self):
        return list(self._instances)

    def totals(self, live_counts_fn, live_only_keys=()):
        """Retired bank + ``live_counts_fn(instance)`` summed over every
        live instance. ``live_only_keys`` (gauges — they retire WITH
        the instance they describe) are summed over live instances but
        never banked. An instance that raises is skipped — one broken
        sink never kills the scrape."""
        # strong refs FIRST: an instance can then only retire before
        # this point (so it's in the bank) or after the scrape — never
        # in between, where it would be missed by both and dent the
        # exported counter's monotonicity for one scrape
        live = self.live()
        with self._lock:
            totals = dict(self._retired)
        for k in live_only_keys:
            totals.setdefault(k, 0)
        for inst in live:
            try:
                counts = live_counts_fn(inst)
            except Exception:  # noqa: BLE001 — scrape survives any sink
                continue
            for k in totals:
                totals[k] += counts.get(k, 0)
        return totals


_default = MetricsRegistry()


def default_registry():
    """The process-global registry every subsystem reports into (the
    ``"metrics"`` wire op / ``tools/export_metrics.py`` scrape it)."""
    return _default


def render_metrics():
    """Prometheus text exposition of the default registry."""
    return _default.render()
