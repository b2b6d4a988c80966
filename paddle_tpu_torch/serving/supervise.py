"""Supervised serving loops: crash and hang detection and restart.

Counterpart of ``paddle_tpu/serving/supervise.py``. The ``MicroBatcher`` and
the ``DecodeBatcher`` each run one loop thread, and each stamps
``heartbeat`` once an iteration. :class:`LoopSupervisor` polls them: a
dead thread (a crash) or a heartbeat older than twice
``FLAGS_serving_loop_watchdog_s`` (a hang the per-step watchdog does not
reach) restarts the loop (``batcher.restart()``: the old thread is
deposed by an epoch bump, its in-flight requests fail typed, a fresh
thread starts), with exponential backoff capped at ``max_backoff``.
Restarts, and failure streaks inside a live loop, feed the
``serving-loops`` ``resilience.CircuitBreaker``; while it is open the
server is degraded (``on_degraded``: generation sheds, ``ping``,
``health`` and ``stats`` answer) until a healthy period closes it
(``on_recovered``). Restart counts and liveness are in ``health()``.
A loop whose ``fatal`` names a reason (its engine's tensor-parallel
group lost a rank: ``serving.tp``) is not restarted; the port's
difference by design, the JAX package's one controller has no such
group.
"""
import threading
import time

from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import CircuitBreaker


class LoopSupervisor:
    """Watches named batcher loops (anything with ``heartbeat``,
    ``alive()``, ``restart(reason)`` and ``consecutive_failures``) and
    restarts the dead or hung ones. Single daemon thread; poll cadence
    derives from the watchdog budget."""

    def __init__(self, stats=None, watchdog_s=None, poll_s=None,
                 restart_threshold=3, reset_secs=5.0,
                 restart_backoff=0.05, max_backoff=2.0,
                 on_degraded=None, on_recovered=None):
        if watchdog_s is None:
            from ..flags import flag
            watchdog_s = flag("serving_loop_watchdog_s")
        self.watchdog_s = float(watchdog_s)
        # a loop whose heartbeat is older than this is hung. 2x the
        # per-execute watchdog: a watchdogged execute stalls the
        # heartbeat for at most ~watchdog_s before the loop reclaims it
        self.hung_after_s = 2.0 * self.watchdog_s
        if poll_s is None:
            poll_s = (max(0.02, min(0.5, self.watchdog_s / 10.0))
                      if self.watchdog_s > 0 else 0.1)
        self.poll_s = float(poll_s)
        self.restart_backoff = float(restart_backoff)
        self.max_backoff = float(max_backoff)
        self.reset_secs = float(reset_secs)
        self.stats = stats
        self.on_degraded = on_degraded
        self.on_recovered = on_recovered
        self.breaker = CircuitBreaker(endpoint="serving-loops",
                                      failure_threshold=restart_threshold,
                                      reset_timeout=reset_secs)
        self._loops = {}       # name -> bookkeeping dict
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._degraded = False
        self._last_failure = 0.0

    # -- registration / lifecycle -----------------------------------------
    def add(self, name, batcher):
        with self._lock:
            self._loops[name] = {
                "batcher": batcher, "restarts": 0,
                "backoff": self.restart_backoff, "next_restart_at": 0.0,
                "last_restart": 0.0,
            }
        return self

    def start(self):
        if not self._loops:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-supervisor")
        self._thread.start()
        return self

    def stop(self, timeout=2):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def degraded(self):
        return self._degraded

    def restarts(self):
        with self._lock:
            return sum(ent["restarts"] for ent in self._loops.values())

    def snapshot(self):
        """Per-loop liveness for the ``health`` op."""
        now = time.monotonic()
        out = {}
        with self._lock:
            loops = dict(self._loops)
        for name, ent in loops.items():
            b = ent["batcher"]
            out[name] = {
                "alive": b.alive(),
                "heartbeat_age_s": round(now - b.heartbeat, 3),
                "restarts": ent["restarts"],
                "consecutive_failures": b.consecutive_failures,
            }
            if ent.get("fatal"):
                out[name]["fatal"] = ent["fatal"]
        return out

    # -- supervision loop --------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self._tick(time.monotonic())
            except Exception:  # noqa: BLE001 — the supervisor never dies
                pass

    def _tick(self, now):
        with self._lock:
            loops = list(self._loops.items())
        all_healthy = True
        for name, ent in loops:
            b = ent["batcher"]
            fatal = getattr(b, "fatal", None)
            if fatal is not None:
                # a loop over a lost tp group is not restarted: its
                # communicator has lost a rank
                all_healthy = False
                if not ent.get("fatal"):
                    ent["fatal"] = fatal
                    _flightrec().record("loop_lost", loop=name,
                                        reason=str(fatal)[:300])
                continue
            dead = not b.alive()
            hung = (not dead and self.watchdog_s > 0
                    and now - b.heartbeat > self.hung_after_s)
            streak = (b.consecutive_failures
                      >= self.breaker.failure_threshold)
            if dead or hung:
                all_healthy = False
                if now >= ent["next_restart_at"]:
                    self._restart(name, ent, now,
                                  "loop thread died" if dead else
                                  f"heartbeat stale "
                                  f"{now - b.heartbeat:.1f}s")
            elif streak:
                # the loop is alive but the engine fails every batch:
                # count it against the breaker without a restart (the
                # loop itself is fine; the card path is not)
                all_healthy = False
                b.consecutive_failures = 0
                self._record_failure(now)
            elif b.consecutive_failures:
                all_healthy = False
            elif now - ent["last_restart"] > self.reset_secs:
                ent["backoff"] = self.restart_backoff
        if all_healthy and self._degraded \
                and now - self._last_failure > self.reset_secs:
            self.breaker.record_success()
            self._degraded = False
            _flightrec().record("recovered")
            if self.on_recovered:
                self.on_recovered()

    def _restart(self, name, ent, now, reason):
        _flightrec().record("loop_restart", loop=name, reason=reason,
                            restarts=ent["restarts"] + 1)
        ent["batcher"].restart(reason=reason)
        ent["restarts"] += 1
        ent["last_restart"] = now
        ent["next_restart_at"] = now + ent["backoff"]
        ent["backoff"] = min(ent["backoff"] * 2.0, self.max_backoff)
        if self.stats:
            self.stats.bump("loop_restarts")
        self._record_failure(now)

    def _record_failure(self, now):
        self._last_failure = now
        self.breaker.record_failure()
        if self.breaker.state != "closed" and not self._degraded:
            self._degraded = True
            _flightrec().record("degraded",
                                breaker=self.breaker.state)
            if self.on_degraded:
                self.on_degraded()
