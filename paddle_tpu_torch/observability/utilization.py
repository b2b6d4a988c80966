"""Live MFU / HBM-bandwidth-utilization gauges.

Counterpart of ``paddle_tpu/observability/utilization.py``. Each timed
execution of a program step, a captured training slab, a served batch
or a decode step is attached to its cost (FLOPs and HBM bytes), so
``run``, ``run_steps``, the serving engine and the decode loop export
``device_mfu_ratio`` / ``device_hbm_bw_util_ratio`` gauges and the raw
``device_flops_total`` / ``device_hbm_bytes_total`` /
``device_compute_ms_total`` counters, labeled by ``where``.

Where the card changes the design:

- **The cost source.** There is no compiled executable to ask
  (``cost_analysis()``): a program's cost is the per-op estimate of
  ``observability.profiling`` over the optimized program (so the live
  gauge and the per-op table agree by construction), and a GPT decode or
  prefill step's is :func:`gpt_step_cost`, from the model's shapes. Each
  is memoized with :func:`cost_for`.
- **The timer.** A host-clock delta between two dispatches on an
  asynchronous CUDA stream measures how fast the host enqueues. An
  :class:`ExecutionTimer` puts a pair of CUDA events around each
  execution on the stream that runs it and reads the pair once it has
  completed (``query()``), never forcing a sync; on the CPU, where an
  execution runs synchronously, the host interval stands.
- **The peaks.** The tables are keyed by the full
  ``torch.cuda.get_device_name()``: the H100 SXM (989 TFLOP/s dense
  bf16, 3.35 TB/s HBM3, NVLink as the inter-card link). Another card
  (the H100 PCIe included, whose peaks are lower) and the CPU get None,
  and their gauges report no ratio. MFU is against the bf16 peak
  whatever the step's type, so a float32 step reads low.

Gauge semantics (the same for every ``where``): achieved rate over the
recent measured-execution window, i.e. utilization while executing. A
stale window (idle longer than the span it covers) is left out of the
exposition. Duty cycle comes from ``device_compute_ms_total`` against
wall time.
"""
import threading
import time
from collections import deque

from .metrics import default_registry

# peak dense bf16 TFLOP/s by torch.cuda.get_device_name() (public specs)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

# peak HBM bytes/s by device name (public specs)
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

# per-card NVLink bytes/s (one direction), the counterpart of the JAX
# package's ICI_PEAK: 18 links of 26.562 GB/s, as nvidia-smi nvlink -s
# reads them on this card
ICI_PEAK = {
    "NVIDIA H100 80GB HBM3": 18 * 26.562e9,
}

# the JAX package's per-host DCN table has no entry here: a cross-host
# fabric is not part of one machine (set_peaks(dcn_bytes_per_s=) sets it)
DCN_PEAK = {}

_override = {"flops": None, "bytes": None, "ici": None, "dcn": None}

_FLOPS = default_registry().counter(
    "device_flops_total", "estimated FLOPs of the measured executions",
    labels=("where",), max_series=16)
_BYTES = default_registry().counter(
    "device_hbm_bytes_total",
    "estimated HBM bytes of the measured executions",
    labels=("where",), max_series=16)
_MS = default_registry().counter(
    "device_compute_ms_total",
    "device milliseconds attributed to measured executions",
    labels=("where",), max_series=16)


def _lookup(table, key, device):
    if _override[key] is not None:
        return _override[key]
    return table.get(_device_kind(device))


def peak_flops(device=None):
    """Peak dense bf16 FLOP/s of ``device`` (default: the current CUDA
    device), or None when the card is not in the table (or there is no
    card). An override through :func:`set_peaks` wins."""
    if _override["flops"] is not None:
        return _override["flops"]
    tf = PEAK_TFLOPS.get(_device_kind(device))
    return None if tf is None else tf * 1e12


def hbm_peak(device=None):
    """Peak HBM bytes/s of ``device``; same contract as
    :func:`peak_flops`."""
    return _lookup(HBM_PEAK, "bytes", device)


def ici_peak(device=None):
    """Per-card NVLink bytes/s of ``device``; same contract as
    :func:`peak_flops`."""
    return _lookup(ICI_PEAK, "ici", device)


def dcn_peak(device=None):
    """Cross-host fabric bytes/s: None unless :func:`set_peaks` set
    it."""
    return _lookup(DCN_PEAK, "dcn", device)


def _device_kind(device):
    try:
        import torch
        if not torch.cuda.is_available():
            return ""
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 — no driver, no gauges
        return ""


# default-device peaks memo for the hot path (the card cannot change
# within a process); set_peaks invalidates
_peaks_memo = None


def _default_peaks():
    global _peaks_memo
    if _peaks_memo is None:
        _peaks_memo = (peak_flops(), hbm_peak())
    return _peaks_memo


def set_peaks(flops_per_s=None, hbm_bytes_per_s=None,
              ici_bytes_per_s=None, dcn_bytes_per_s=None):
    """Override the peak tables (an unlisted card, or tests that need
    deterministic ratios on the CPU). ``None`` restores the table lookup
    for that peak: every call re-states all four, so ``set_peaks()`` is
    a full reset."""
    global _peaks_memo
    _override["flops"] = flops_per_s
    _override["bytes"] = hbm_bytes_per_s
    _override["ici"] = ici_bytes_per_s
    _override["dcn"] = dcn_bytes_per_s
    _peaks_memo = None


def cost_for(memo, key, compute):
    """``compute()`` (a ``{"flops", "bytes"}`` dict, or None when nothing
    can be counted), memoized in the LRU ``memo`` under ``key`` (False =
    nothing to count). A miss recomputes, so an evicted entry never
    freezes the gauges."""
    cost = memo.get(key)
    if cost is None:
        cost = compute() or False
        memo.put(key, cost)
    return cost


def gpt_step_cost(cfg, ctx_lens, new_tokens=1, logits_per_row=1,
                  kv_itemsize=4, param_itemsize=4):
    """``{"flops", "bytes"}`` of one GPT forward over ``len(ctx_lens)``
    rows, each taking ``new_tokens`` new positions after a context of
    ``ctx_lens[r]`` cached ones (a decode step: 1 over the row's
    position; a prefill bucket of S tokens: S over 0), with
    ``logits_per_row`` rows of the tied LM head each (1: the next token;
    a verify span scores every position).

    FLOPs: 2 x the non-embedding parameters x tokens, 2 x vocab x hidden
    per logits row, and the attention: QK^T and PV take 4 x hidden FLOPs
    per (query, visible key) pair and layer, each new query seeing the
    context and the new positions up to itself. Bytes: the weights once
    (non-embedding and the tied embedding, ``param_itemsize``), the
    context's K and V read and the new positions' K and V written
    (``kv_itemsize``)."""
    import numpy as np
    d, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    ffn = getattr(cfg, "ffn_size", None) or 4 * d
    # per layer: qkv + out projection (4d^2 + 4d), the MLP
    # (2 d ffn + ffn + d), two layer norms (4d); the final layer norm
    params = L * (4 * d * d + 4 * d + 2 * d * ffn + ffn + d + 4 * d) + 2 * d
    ctx = np.asarray(ctx_lens, np.float64).reshape(-1)
    rows, s = int(ctx.size), int(new_tokens)
    tokens = rows * s
    pairs = float(s * ctx.sum() + rows * s * (s + 1) / 2)
    flops = (2.0 * params * tokens + 2.0 * V * d * rows * logits_per_row
             + 4.0 * d * L * pairs)
    kv = 2.0 * L * d * kv_itemsize * (float(ctx.sum()) + tokens)
    nbytes = float(params + V * d) * param_itemsize + kv
    return {"flops": flops, "bytes": nbytes}


class ExecutionTimer:
    """Times executions without forcing a sync. :meth:`begin` marks the
    start (a CUDA event recorded on the device's current stream, or the
    host clock on the CPU), :meth:`end` the end with a payload;
    :meth:`poll` returns ``(seconds, payload)`` of every pair that has
    completed, oldest first (an incomplete one holds back those after
    it). Pending pairs are bounded: past ``max_pending`` the oldest is
    dropped unread."""

    def __init__(self, max_pending=64):
        self._pending = deque()
        self._max = int(max_pending)
        self._lock = threading.Lock()

    def begin(self, device):
        """A start mark for an execution about to be enqueued on
        ``device``."""
        if getattr(device, "type", device) == "cuda":
            import torch
            stream = torch.cuda.current_stream(device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            return (ev, stream)
        return time.perf_counter()

    def end(self, start, payload):
        """The end mark of the execution :meth:`begin` started."""
        if isinstance(start, float):
            item = (time.perf_counter() - start, None, payload)
        else:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(start[1])
            item = (start[0], ev, payload)
        with self._lock:
            self._pending.append(item)
            while len(self._pending) > self._max:
                self._pending.popleft()

    def poll(self):
        out = []
        with self._lock:
            while self._pending:
                start, stop, payload = self._pending[0]
                if stop is None:
                    out.append((start, payload))
                elif stop.query():
                    out.append((start.elapsed_time(stop) / 1e3, payload))
                else:
                    break
                self._pending.popleft()
        return out


class _Window:
    """Sliding window with O(1) running totals (add the new
    observation, subtract the evicted one) and its OWN lock, so the
    decode loop, the micro-batcher and the executor never contend on
    one global lock for O(window) re-summation. The totals are
    recomputed from the deque every 4096 observations to shed
    accumulated float drift. Each observation also stamps wall time
    (monotonic) — the staleness contract below reads the stamps."""

    __slots__ = ("obs", "t", "f", "b", "n", "lock", "last_wall")

    def __init__(self):
        self.obs = deque(maxlen=64)     # (seconds, flops, bytes, wall)
        self.t = self.f = self.b = 0.0
        self.n = 0
        self.last_wall = 0.0
        self.lock = threading.Lock()

    def add(self, seconds, flops, nbytes):
        now = time.monotonic()
        with self.lock:
            if len(self.obs) == self.obs.maxlen:
                es, ef, eb, _ew = self.obs[0]
                self.t -= es
                self.f -= ef
                self.b -= eb
            self.obs.append((seconds, flops, nbytes, now))
            self.t += seconds
            self.f += flops
            self.b += nbytes
            self.n += 1
            self.last_wall = now
            if self.n % 4096 == 0:      # shed float drift
                self.t = sum(o[0] for o in self.obs)
                self.f = sum(o[1] for o in self.obs)
                self.b = sum(o[2] for o in self.obs)

    def snapshot(self):
        """(exec_seconds, flops, bytes, wall_span, last_wall) of the
        retained window — one consistent copy."""
        with self.lock:
            if not self.obs:
                return None
            span = self.last_wall - self.obs[0][3]
            return self.t, self.f, self.b, span, self.last_wall


# a window is STALE once it has been idle longer than the wall span it
# covers (floored so a two-observation window isn't stale a split
# second later): a stopped/idle server must read as "no current
# utilization", not as its last busy-period gauge forever
_STALE_FLOOR_S = 1.0

_windows = {}
_lock = threading.Lock()        # guards the _windows dict only


def observe_execution(where, cost, seconds):
    """Attach one timed execution with ``cost`` (a ``{"flops",
    "bytes"}`` dict) to the live gauges for ``where``
    ("train", "step", "infer", "prefill", "decode", ...). Counters bump
    unconditionally; the MFU/BW ratio gauges are derived from the
    sliding window AT SCRAPE TIME (see :func:`_collect_ratios`) so an
    idle window goes stale instead of freezing at its last value."""
    if not cost or seconds <= 0:    # None AND cost_for's False sentinel
        return
    flops, nbytes = cost["flops"], cost["bytes"]
    lab = (where,)
    _FLOPS.inc(flops, labels=lab)
    _BYTES.inc(nbytes, labels=lab)
    _MS.inc(seconds * 1e3, labels=lab)
    pf, pb = _default_peaks()
    if pf is None and pb is None:
        return
    w = _windows.get(where)
    if w is None:
        with _lock:
            w = _windows.setdefault(where, _Window())
    w.add(seconds, flops, nbytes)




def _window_ratios(where, now=None):
    """(mfu, bw, stale) computed from the retained window, or None when
    never observed / peaks unknown. Each ratio is individually None
    when ITS peak is unknown (an operator who only set the FLOP peak
    must not export a false 0.0 bandwidth utilization)."""
    w = _windows.get(where)
    if w is None:
        return None
    snap = w.snapshot()
    if snap is None:
        return None
    t, f, b, span, last_wall = snap
    if t <= 0:
        return None
    pf, pb = _default_peaks()
    if pf is None and pb is None:
        return None
    now = time.monotonic() if now is None else now
    stale = (now - last_wall) > max(span, _STALE_FLOOR_S)
    mfu = min(f / t / pf, 1.0) if pf else None
    bw = min(b / t / pb, 1.0) if pb else None
    return mfu, bw, stale


def _collect_ratios():
    """Scrape-time collector for the MFU / HBM-bw ratio gauges: derived
    from the sliding windows at scrape time, SKIPPING stale windows —
    a stopped server's exposition simply stops carrying the series
    instead of exporting its last busy reading forever."""
    with _lock:
        wheres = list(_windows)
    mfu_s, bw_s = [], []
    now = time.monotonic()
    for where in wheres:
        r = _window_ratios(where, now=now)
        if r is None or r[2]:           # unknown peaks / stale: skip
            continue
        if r[0] is not None:
            mfu_s.append(((where,), r[0]))
        if r[1] is not None:
            bw_s.append(((where,), r[1]))
    return [
        {"name": "device_mfu_ratio", "kind": "gauge",
         "help": "achieved / peak FLOP rate over the recent "
                 "measured-execution window (utilization WHILE "
                 "executing; stale/idle windows are omitted — duty "
                 "cycle comes from device_compute_ms_total vs wall "
                 "clock)",
         "labels": ("where",), "samples": mfu_s},
        {"name": "device_hbm_bw_util_ratio", "kind": "gauge",
         "help": "achieved / peak HBM bandwidth over the recent "
                 "measured-execution window (clamped at 1.0: the byte "
                 "estimate counts every op's inputs and outputs and can "
                 "overcount; stale/idle windows are omitted)",
         "labels": ("where",), "samples": bw_s},
    ]


default_registry().register_collector(
    _collect_ratios,
    families=[
        {"name": "device_mfu_ratio", "kind": "gauge",
         "help": "achieved / peak FLOP rate over the recent "
                 "measured-execution window", "labels": ("where",)},
        {"name": "device_hbm_bw_util_ratio", "kind": "gauge",
         "help": "achieved / peak HBM bandwidth over the recent "
                 "measured-execution window", "labels": ("where",)},
    ])


def utilization(where):
    """Current window readings ``{mfu, hbm_bw_util, stale}`` for
    ``where`` (zeros / stale=False when never observed or peaks
    unknown). ``stale=True`` means the window has been idle longer
    than the wall span it covers — the reading describes a PAST busy
    period, not the present (the Prometheus collector omits the series
    entirely in that state)."""
    r = _window_ratios(where)
    if r is None:
        return {"mfu": 0.0, "hbm_bw_util": 0.0, "stale": False}
    return {"mfu": r[0] or 0.0, "hbm_bw_util": r[1] or 0.0,
            "stale": r[2]}


def reset_windows():
    """Drop the sliding windows (tests; the ratio series disappear from
    the exposition until the next observation)."""
    with _lock:
        _windows.clear()
