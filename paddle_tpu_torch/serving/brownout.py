"""Brownout: a server whose SLO rules breach degrades its lowest
priority classes first and recovers symmetrically.

A copy of ``paddle_tpu/serving/brownout.py``. The level follows the
number of breached rules of the server's ``observability.slo``
monitor:

- **level 0** (nothing breached): nothing changes;
- **level 1** (one breached rule): ``best_effort`` requests are shed
  typed at the door (``ServerOverloadedError``); ``batch`` generation
  budgets are capped at ``batch_token_cap`` new tokens and ``batch``
  admission shrinks to half the queue depth; ``batch`` rows draft at
  half depth and ``best_effort`` rows not at all (speculative decoding);
- **level 2** (two or more breached rules, or a level-1 breach held
  ``escalate_s``): ``batch`` sheds too. ``interactive`` traffic is
  served at every level.

After ``recover_s`` seconds with nothing breached the level steps down
one rung (not straight to 0). Transitions are flight-recorded and
exported as ``serving_brownout_level_state{scope}``.
"""
import threading
import time

from ..flags import flag as _flag
from ..observability.metrics import default_registry
from ..observability.recorder import flight_recorder as _flightrec

# 256 series like the slo_* families: one scope per server, and a
# process running many servers churns through more than 64
_LEVEL = default_registry().gauge(
    "serving_brownout_level_state",
    "current brownout degradation level (0 = normal, 1 = best_effort "
    "shed + batch capped, 2 = batch shed too), by server scope",
    labels=("scope",), max_series=256)


class BrownoutController:
    """Maps SLO breach state to a degradation level with hysteresis.

    ``breached_fn()`` returns the CURRENT number of breached SLO rules
    (the server wires ``len(slo_monitor.breached())``). ``level()`` is
    evaluated lazily on every admission — no extra thread — and walks
    the ladder described in the module docstring. All transitions are
    flight-recorded and exported via
    ``serving_brownout_level_state{scope}``.
    """

    MAX_LEVEL = 2

    def __init__(self, breached_fn, *, scope="default", enabled=None,
                 escalate_s=2.0, recover_s=2.0, batch_token_cap=16):
        self._breached_fn = breached_fn
        self.scope = str(scope)
        self.enabled = bool(_flag("serving_brownout")
                            if enabled is None else enabled)
        self.escalate_s = float(escalate_s)
        self.recover_s = float(recover_s)
        self.batch_token_cap = int(batch_token_cap)
        self._level = 0
        self._level_since = None      # when the CURRENT level was set
        self._breach_since = None     # start of the current breach run
        self._healthy_since = None    # start of the current 0-breach run
        self._transitions = 0
        self._shed = 0
        self._capped = 0
        self._lock = threading.Lock()
        _LEVEL.set(0, labels=(self.scope,))

    def _set_level(self, lvl, now, breached):
        self._level = lvl
        self._level_since = now
        self._transitions += 1
        _LEVEL.set(lvl, labels=(self.scope,))
        _flightrec().record("brownout", scope=self.scope, level=lvl,
                            breached=int(breached))

    def level(self, now=None):
        """Current degradation level (0/1/2), re-evaluated from the
        live breach count with escalate/recover hysteresis."""
        if not self.enabled:
            return 0
        try:
            breached = int(self._breached_fn() or 0)
        except Exception:  # noqa: BLE001 — a dying monitor reads as ok
            breached = 0
        now = time.monotonic() if now is None else now
        with self._lock:
            if breached > 0:
                self._healthy_since = None
                if self._breach_since is None:
                    self._breach_since = now
                target = 2 if breached >= 2 else 1
                if self._level < target:
                    self._set_level(target, now, breached)
                elif (self._level < self.MAX_LEVEL
                        and now - self._breach_since
                        >= self.escalate_s):
                    # THIS breach run (not time-at-level: a fresh
                    # breach after a healthy gap restarts the clock)
                    # outlived escalate_s without the current rung
                    # clearing it — one more rung
                    self._set_level(self._level + 1, now, breached)
            elif self._level > 0:
                self._breach_since = None
                if self._healthy_since is None:
                    self._healthy_since = now
                elif now - self._healthy_since >= self.recover_s:
                    # symmetric recovery: one rung per recover_s of
                    # sustained health
                    self._set_level(self._level - 1, now, breached)
                    self._healthy_since = now
            else:
                self._breach_since = None
                self._healthy_since = None
            return self._level

    def admission(self, rank, max_new_tokens=None, queue_depth=None):
        """Admission verdict for a request of priority ``rank`` at the
        current level: ``(shed, max_new_tokens, depth_cap)``. ``shed``
        True means the caller must refuse the request typed;
        ``max_new_tokens`` comes back clamped for capped classes;
        ``depth_cap`` is an admission-depth override (None = the
        queue's own limit)."""
        lvl = self.level()
        if lvl <= 0 or rank <= 0:
            return False, max_new_tokens, None
        if rank >= 2 or lvl >= 2:
            # best_effort sheds at level 1; batch joins it at level 2
            with self._lock:
                self._shed += 1
            return True, max_new_tokens, None
        # level 1, batch: capped budget + shrunken admission
        capped = max_new_tokens
        if max_new_tokens is not None \
                and max_new_tokens > self.batch_token_cap:
            capped = self.batch_token_cap
            with self._lock:
                self._capped += 1
        depth_cap = max(queue_depth // 2, 1) if queue_depth else None
        return False, capped, depth_cap

    def draft_depth(self, rank, k):
        """Speculative draft depth for a row of priority ``rank`` at the
        current level. Drafting is OPTIONAL work — extra verify compute
        spent betting on acceptance — so the ladder shrinks it for the
        same classes whose admission it degrades, before touching their
        admission at the next rung: at level 1 ``batch`` rows draft at
        half depth and ``best_effort`` rows stop drafting; at level 2
        ``batch`` stops too. Interactive rows keep their full ``k`` at
        every level (they degrade LAST, same as admission)."""
        k = int(k)
        lvl = self.level()
        if lvl <= 0 or rank <= 0 or k <= 0:
            return k
        if rank >= 2 or lvl >= 2:
            return 0
        return max(k // 2, 1)

    def snapshot(self):
        with self._lock:
            return {"level": self._level, "enabled": self.enabled,
                    "transitions": self._transitions,
                    "shed": self._shed, "capped": self._capped}
