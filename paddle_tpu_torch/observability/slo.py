"""Rule-driven SLO monitor: metric streams -> typed alert events.

Counterpart of ``paddle_tpu/observability/slo.py``. :class:`SloMonitor`
evaluates declarative :class:`SloRule` s on a supervised loop (or
through :meth:`SloMonitor.evaluate_once`, the deterministic path) and
turns threshold crossings into:

- ``slo_breach`` / ``slo_recovered`` flight-recorder events,
- ``slo_breached_total{scope, rule}`` and ``slo_rule_state{scope, rule}``
  registry metrics,
- an optional callback (the remediation hook).

Rule sources (checked in this order):

- ``getter``: any callable returning a float (None = no data): the
  per-instance escape hatch (queue depth, kvpool occupancy read off the
  server object);
- ``hist``: a ``serving.metrics.LatencyHistogram``; the value is the
  ``q`` quantile over the observations since the last evaluation (a
  windowed histogram recovers, a cumulative one never would); an empty
  window is "no data";
- ``metric`` (+ ``labels``): a family of a ``MetricsRegistry``:
  ``source="value"`` the current counter or gauge, ``"rate"`` the
  per-second delta between evaluations, ``"quantile"`` the windowed
  bucket-delta quantile of a registry histogram.

A rule trips once its condition has held ``for_s`` seconds; it recovers
at once when the condition reads false or the source goes silent (an
idle replica is not a breached one).
"""
import threading
import time

from ..flags import flag as _flag
from .metrics import default_registry
from .recorder import flight_recorder as _flightrec

# 256, not the default 64: every InferenceServer mints a monitor scope
# with several rules, and an in-process fleet (tests, bench, embedded
# replicas) legitimately churns through far more than 64 (scope, rule)
# pairs — overflowing the cap folds a NEW server's series into _other
# and its breach state reads as permanently 0
_BREACHED = default_registry().counter(
    "slo_breached_total",
    "SLO rule breach transitions (ok -> breached), by monitor scope "
    "and rule",
    labels=("scope", "rule"), max_series=256)
_STATE = default_registry().gauge(
    "slo_rule_state",
    "current SLO rule state (0 = ok, 1 = breached), by monitor scope "
    "and rule",
    labels=("scope", "rule"), max_series=256)

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}


class SloRule:
    """One declarative rule: ``value <op> threshold`` held ``for_s``
    seconds = breach. Exactly one source: ``getter``, ``hist``, or
    ``metric`` (see module docstring)."""

    __slots__ = ("name", "op", "threshold", "for_s", "metric", "labels",
                 "source", "q", "getter", "hist")

    def __init__(self, name, op, threshold, *, metric=None, labels=(),
                 source="value", q=0.99, getter=None, hist=None,
                 for_s=0.0):
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: op must be one of "
                             f"{sorted(_OPS)}, got {op!r}")
        if source not in ("value", "rate", "quantile"):
            raise ValueError(f"rule {name!r}: unknown source {source!r}")
        if getter is None and hist is None and metric is None:
            raise ValueError(f"rule {name!r} needs a getter, hist, or "
                             f"metric source")
        self.name = str(name)
        self.op = op
        self.threshold = float(threshold)
        self.for_s = float(for_s)
        self.metric = metric
        self.labels = tuple(labels)
        self.source = source
        self.q = float(q)
        self.getter = getter
        self.hist = hist


def _bucket_quantile(bounds, counts, q):
    """q-quantile (0..1) over per-bucket counts (NOT cumulative), with
    the standard linear interpolation; None when the window is empty.
    The overflow bucket interpolates to the last finite bound (the
    Prometheus convention)."""
    total = sum(counts)
    if not total:
        return None
    target = total * q
    seen = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            return lo + (max(hi, lo) - lo) * ((target - seen) / c)
        seen += c
    return bounds[-1]


class SloMonitor:
    """Evaluates a rule set on a supervised loop (or explicitly via
    :meth:`evaluate_once` — the deterministic test/embedding path).

    ``on_event(rule, breached, value)`` fires on every transition.
    ``scope`` labels this monitor's metric series (several in-process
    servers must not collide on one gauge)."""

    def __init__(self, rules, *, registry=None, scope="default",
                 poll_s=None, on_event=None):
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.registry = registry or default_registry()
        self.scope = str(scope)
        self.poll_s = float(poll_s if poll_s is not None
                            else _flag("slo_poll_s"))
        self.on_event = on_event
        self._state = {r.name: {"breached": False, "pending_since": None,
                                "value": None, "since": None}
                       for r in self.rules}
        # per-rule window memory for rate/quantile sources
        self._prev = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.evaluations = 0
        for r in self.rules:
            _STATE.set(0, labels=(self.scope, r.name))

    # -- sources ----------------------------------------------------------
    def _registry_samples(self, name, scrape):
        """One registry scrape is shared by every metric rule of an
        evaluation pass (collect() runs every scrape-time collector in
        the process — paying it per RULE per poll would make rule count
        a scrape multiplier)."""
        if scrape.get("_cat") is None:
            scrape["_cat"] = self.registry.collect()
        fam = scrape["_cat"].get(name)
        return fam["samples"] if fam else []

    def _match(self, samples, labels):
        for values, payload in samples:
            if tuple(values) == tuple(labels):
                return payload
        return None

    def _value(self, rule, now, scrape):
        """Current rule value, or None = no data this window."""
        if rule.getter is not None:
            return rule.getter()
        if rule.hist is not None:
            with rule.hist._lock:
                counts = list(rule.hist._counts)
            prev = self._prev.get(rule.name)
            self._prev[rule.name] = ("hist", now, counts)
            if prev is None:
                window = counts
            else:
                window = [a - b for a, b in zip(counts, prev[2])]
            return _bucket_quantile(rule.hist.bounds_ms, window, rule.q)
        payload = self._match(self._registry_samples(rule.metric,
                                                     scrape),
                              rule.labels)
        if payload is None:
            return None
        if rule.source == "quantile":
            # payload: {"buckets": [(le, cumulative)], "count", "sum"}
            cum = [c for _le, c in payload["buckets"]]
            bounds = [le for le, _c in payload["buckets"]
                      if le != float("inf")]
            counts = [c - (cum[i - 1] if i else 0)
                      for i, c in enumerate(cum)]
            prev = self._prev.get(rule.name)
            self._prev[rule.name] = ("q", now, counts)
            window = counts if prev is None else \
                [a - b for a, b in zip(counts, prev[2])]
            return _bucket_quantile(bounds, window, rule.q)
        value = float(payload)
        if rule.source == "rate":
            prev = self._prev.get(rule.name)
            self._prev[rule.name] = ("rate", now, value)
            if prev is None or now <= prev[1]:
                return None
            return (value - prev[2]) / (now - prev[1])
        return value

    # -- evaluation -------------------------------------------------------
    def evaluate_once(self, now=None):
        """One evaluation pass over every rule; returns the snapshot.
        Safe to call concurrently with the loop (shared lock)."""
        now = time.monotonic() if now is None else now
        scrape = {"_cat": None}    # lazy, shared across this pass
        with self._lock:
            self.evaluations += 1
            for rule in self.rules:
                st = self._state[rule.name]
                try:
                    value = self._value(rule, now, scrape)
                except Exception:  # noqa: BLE001 — one rule never kills
                    value = None   # the monitor; no-data semantics
                st["value"] = value
                violated = (value is not None
                            and _OPS[rule.op](value, rule.threshold))
                if violated:
                    if st["pending_since"] is None:
                        st["pending_since"] = now
                    held = now - st["pending_since"]
                    if not st["breached"] and held >= rule.for_s:
                        self._transition(rule, st, True, value, now)
                else:
                    st["pending_since"] = None
                    if st["breached"]:
                        self._transition(rule, st, False, value, now)
            return self._snapshot_locked()

    def _transition(self, rule, st, breached, value, now):
        st["breached"] = breached
        st["since"] = now
        labels = (self.scope, rule.name)
        _STATE.set(1 if breached else 0, labels=labels)
        if breached:
            _BREACHED.inc(labels=labels)
        _flightrec().record(
            "slo_breach" if breached else "slo_recovered",
            scope=self.scope, rule=rule.name,
            value=None if value is None else round(float(value), 4),
            threshold=rule.threshold, op=rule.op)
        if self.on_event is not None:
            try:
                self.on_event(rule, breached, value)
            except Exception:  # noqa: BLE001 — user hook never kills us
                pass

    def _snapshot_locked(self):
        return {name: {"breached": st["breached"], "value": st["value"],
                       "since": st["since"]}
                for name, st in self._state.items()}

    def snapshot(self):
        with self._lock:
            return self._snapshot_locked()

    def breached(self):
        """Names of currently breached rules (a router's dispatch
        penalty reads the count)."""
        with self._lock:
            return [n for n, st in self._state.items() if st["breached"]]

    def breached_count(self):
        return len(self.breached())

    # -- supervised loop --------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slo-monitor")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the monitor never dies
                pass

    def stop(self, timeout=2.0):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
        # a stopped monitor's gauges report 0: its scope is gone, and a
        # frozen breached=1 series would page forever for a dead server
        for r in self.rules:
            _STATE.set(0, labels=(self.scope, r.name))


def default_server_rules(server):
    """The default serving ruleset (wired by ``InferenceServer.start``
    under ``FLAGS_slo_monitor``): p99 inter-token latency (windowed
    decode-stage quantile), queue-depth ratios, kvpool occupancy, and —
    opt-in via ``FLAGS_slo_mfu_floor`` > 0 — an MFU floor on the decode
    path. Thresholds come from the ``FLAGS_slo_*`` knobs; a threshold
    of 0 disables its rule."""
    from .utilization import utilization
    rules = []
    cap = max(int(server.config.queue_depth), 1)
    p99_ms = float(_flag("slo_decode_p99_ms"))
    q_ratio = float(_flag("slo_queue_ratio"))
    kv_ratio = float(_flag("slo_kvpool_ratio"))
    mfu_floor = float(_flag("slo_mfu_floor"))
    if server.gen_queue is not None:
        if p99_ms > 0:
            # the "token" stage is one WHOLE decode-loop step (decode +
            # sample + any stall) — the true inter-token latency
            rules.append(SloRule(
                "intertoken_p99_ms", ">", p99_ms,
                hist=server.stats_sink.hist["token"], q=0.99,
                for_s=1.0))
        if q_ratio > 0:
            rules.append(SloRule(
                "decode_queue_ratio", ">", q_ratio,
                getter=lambda q=server.gen_queue: len(q) / cap))
        pool = server.gen_engine.pool
        if pool is not None and kv_ratio > 0:
            def _occ(pool=pool):
                c = pool.capacity_blocks
                return (pool.blocks_in_use() / c) if c else 0.0
            rules.append(SloRule("kvpool_occupancy", ">", kv_ratio,
                                 getter=_occ))
        if mfu_floor > 0:
            def _mfu():
                u = utilization("decode")
                if u.get("stale") or not u["mfu"]:
                    return None        # idle/unknown card: no data
                return u["mfu"]
            rules.append(SloRule("decode_mfu_floor", "<", mfu_floor,
                                 getter=_mfu, for_s=5.0))
    if server.queue is not None and q_ratio > 0:
        rules.append(SloRule(
            "infer_queue_ratio", ">", q_ratio,
            getter=lambda q=server.queue: len(q) / cap))
    return rules
