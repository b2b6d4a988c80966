"""Model-health monitoring: a diverging run caught before the NaN
guard.

A copy of ``paddle_tpu/train/health.py``. ``check_nan_inf`` fires once a
value is already non-finite; :class:`HealthMonitor` watches what comes
before: a loss spiking above its trailing average, a global gradient
norm exploding, an update ratio jumping. :meth:`~HealthMonitor.
ensure_fetches` appends reduction ops to the training program once (the
global grad norm over every ``param@GRAD``, the global param norm, and
the update ratio ~ grad norm x lr / param norm); on a health slab they
are fetched with the slab's other fetches (a second captured step of
their own, since a captured step is keyed by its fetch list), on the
others they are dead code the pass pipeline drops, so those slabs run
bitwise as before. :meth:`~HealthMonitor.observe` sets the
``train_health_loss_value``, ``train_health_grad_norm_value`` and
``train_health_update_ratio`` gauges and evaluates the rules through an
``observability.slo.SloMonitor`` (default: loss over
``FLAGS_train_loss_spike_ratio`` times its trailing EMA, grad norm over
``FLAGS_train_grad_spike_ratio`` times its); a breach records a
``train_health_breach`` flight event and calls ``on_breach(rule,
value)``. ``TrainingSupervisor(health_every_n=N)`` wires it; 0 (the
default of ``FLAGS_train_health_every_n``) builds nothing.
"""
import time

from ..flags import flag as _flag
from ..observability.metrics import default_registry as _registry
from ..observability.recorder import flight_recorder as _flightrec
from ..observability.slo import SloMonitor, SloRule

_LOSS = _registry().gauge(
    "train_health_loss_value",
    "per-slab training loss (last step of the most recent health slab)")
_GNORM = _registry().gauge(
    "train_health_grad_norm_value",
    "global gradient L2 norm at the most recent health slab")
_UPDATE = _registry().gauge(
    "train_health_update_ratio",
    "parameter-update ratio (grad-norm x lr / param-norm proxy) at "
    "the most recent health slab")

_EMA_ALPHA = 0.3


class HealthMonitor:
    """Per-supervisor health monitor. Build once per training program;
    ``ensure_fetches(loss_name)`` is idempotent."""

    def __init__(self, program, *, every_n=None, rules=None,
                 on_breach=None, for_s=0.0, scope_label="train_health"):
        self.program = program
        # fail FAST on a config error: this constructor runs at
        # TrainingSupervisor build time, outside the supervised-restart
        # loop — a forward-only program must raise here, not burn the
        # restart budget re-hitting the same ValueError every attempt
        gb = program.global_block()
        if not any(getattr(v, "persistable", False)
                   and (v.name + "@GRAD") in gb.vars
                   for v in list(gb.vars.values())):
            raise ValueError(
                "HealthMonitor: the program has no param@GRAD "
                "variables — health monitoring needs a training "
                "program (optimizer.minimize applied)")
        self.every_n = int(every_n if every_n is not None
                           else _flag("train_health_every_n"))
        self.on_breach = on_breach
        self._fetch_names = None
        self._loss_name = None
        self._ema = {"loss": None, "grad_norm": None}
        self._last = {"loss": None, "grad_norm": None,
                      "update_ratio": None}
        self._last_slab = None
        self.breaches = []      # (rule_name, value, slab_idx)
        self.monitor = SloMonitor(
            rules if rules is not None else self._default_rules(for_s),
            scope=scope_label, on_event=self._on_event)

    # -- rules -------------------------------------------------------------
    def _default_rules(self, for_s):
        return [
            SloRule("loss_spike", ">",
                    float(_flag("train_loss_spike_ratio")),
                    getter=lambda: self._spike("loss"), for_s=for_s),
            SloRule("grad_norm_spike", ">",
                    float(_flag("train_grad_spike_ratio")),
                    getter=lambda: self._spike("grad_norm"),
                    for_s=for_s),
        ]

    def _spike(self, key):
        """Current value / trailing EMA (None = no data yet). The EMA
        advances in :meth:`observe` AFTER evaluation, so a spike is
        judged against history that does not yet include it."""
        cur, ema = self._last[key], self._ema[key]
        if cur is None or ema is None or ema <= 0:
            return None
        return cur / ema

    def _on_event(self, rule, breached, value):
        if not breached:
            return
        v = None if value is None else float(value)
        self.breaches.append((rule.name, v, self._last_slab))
        _flightrec().record(
            "train_health_breach", rule=rule.name,
            value=None if v is None else round(v, 4),
            threshold=rule.threshold, slab=self._last_slab,
            loss=self._last["loss"], grad_norm=self._last["grad_norm"])
        if self.on_breach is not None:
            try:
                self.on_breach(rule.name, v)
            except Exception:  # noqa: BLE001 — user hook never kills
                pass           # the training loop

    # -- in-graph fetch construction --------------------------------------
    def ensure_fetches(self, loss_name=None):
        """Append the health reduction ops to the program (once) and
        return the health fetch names ``[loss, grad_norm,
        update_ratio]`` (loss omitted when no loss var is known). Pure
        ops only: unfetched they are dead code, so every non-health
        slab is bitwise what it was before this call."""
        if self._fetch_names is not None:
            return self._fetch_names
        gb = self.program.global_block()
        if loss_name is not None and loss_name in gb.vars:
            self._loss_name = loss_name
        # idempotent PER PROGRAM: a second monitor on the same program
        # (fresh supervisor, same training job) must reuse the existing
        # health ops — appending another set would bump the program
        # version and invalidate every captured step
        norms = getattr(self.program, "_health_norm_names", None)
        if norms is None:
            norms = self._build_norm_ops(gb)
            self.program._health_norm_names = norms
        names = ([self._loss_name] if self._loss_name else []) \
            + list(norms)
        self._fetch_names = names
        return names

    def _build_norm_ops(self, gb):
        from ..framework.core import program_guard
        from ..layers import math as _lmath, nn as _lnn
        params = [v.name for v in list(gb.vars.values())
                  if getattr(v, "persistable", False)
                  and (v.name + "@GRAD") in gb.vars]
        lr_name = next(
            (v.name for v in list(gb.vars.values())
             if getattr(v, "persistable", False)
             and v.name.startswith("learning_rate")
             and not v.name.endswith("@GRAD")), None)
        with program_guard(self.program):
            gsq = [_lmath.reduce_sum(_lnn.square(gb.var(n + "@GRAD")))
                   for n in params]
            gnorm = _lnn.sqrt(_lmath.sums(gsq))
            psq = [_lmath.reduce_sum(_lnn.square(gb.var(n)))
                   for n in params]
            # post-update ‖param‖ (the ops read state after the
            # optimizer ran) — a fine denominator for a health PROXY
            pnorm = _lnn.sqrt(_lmath.sums(psq))
            step = gnorm if lr_name is None else \
                _lmath.elementwise_mul(gnorm, gb.var(lr_name))
            ratio = _lmath.elementwise_div(
                step, _lmath.scale(pnorm, bias=1e-12))
        return (gnorm.name, ratio.name)

    def is_health_slab(self, slab_idx):
        return self.every_n > 0 and slab_idx % self.every_n == 0

    # -- observation -------------------------------------------------------
    def observe(self, slab_idx, values, now=None):
        """Land one health slab's fetched values (stacked per-step
        arrays in :meth:`ensure_fetches` order; the LAST step of the
        slab — the freshest state — is the reported sample) and
        evaluate the rules."""
        import numpy as np
        self._last_slab = int(slab_idx)
        vals = [float(np.asarray(v).reshape(-1)[-1]) for v in values]
        i = 0
        if self._loss_name:
            self._last["loss"] = vals[i]
            _LOSS.set(vals[i])
            i += 1
        self._last["grad_norm"] = vals[i]
        _GNORM.set(vals[i])
        self._last["update_ratio"] = vals[i + 1]
        _UPDATE.set(vals[i + 1])
        snap = self.monitor.evaluate_once(
            now=time.monotonic() if now is None else now)
        # EMA advances AFTER evaluation: the spike ratio compares the
        # new sample against trailing history only
        for key in ("loss", "grad_norm"):
            cur = self._last[key]
            if cur is None or not np.isfinite(cur):
                continue
            prev = self._ema[key]
            self._ema[key] = cur if prev is None else \
                prev * (1.0 - _EMA_ALPHA) + cur * _EMA_ALPHA
        return snap

    def snapshot(self):
        """{"values", "ema", "breached", "breaches"} — the live view
        ``TrainingSupervisor.health_report()`` returns."""
        return {"values": dict(self._last), "ema": dict(self._ema),
                "breached": self.monitor.breached(),
                "breaches": list(self.breaches),
                "every_n": self.every_n}
