"""Runtime flags of the PyTorch port: the subset of ``paddle_tpu.flags``
that the ported paths read, with the same names, the same defaults (but
``cudnn_deterministic``, on in the port) and the same ``FLAGS_<name>``
environment override (read once, at import).

``flag(name)`` is the getter; ``get_flags``/``set_flags`` are the
``fluid`` ones (names with or without the ``FLAGS_`` prefix).
"""
import os

_DEFS = {
    # name: (default, type)
    # -- serving front end --
    # admission: hard pending-request cap (backpressure) and the default
    # per-request deadline (0 = no deadline unless the request sets one)
    "serving_queue_depth": (256, int),
    "serving_default_deadline_ms": (0.0, float),
    # load-shed breaker: consecutive queue-full refusals that open it,
    # and how long it sheds before re-probing
    "serving_shed_failures": (8, int),
    "serving_shed_reset_secs": (0.5, float),
    # -- serving resilience --
    # wall-clock budget per batcher execute / decode step (run on a
    # resilience.WatchdogWorker, so a hung card call fails that
    # batch's clients instead of wedging the loop) and the supervisor's
    # stale-heartbeat threshold (twice this). Must exceed the worst-case
    # first-shape capture; 0 disables the watchdog and the hang detector
    "serving_loop_watchdog_s": (60.0, float),
    # client-side hedged requests: hedge `infer` after this many ms
    # without a reply (the observed p99 once the client has seen enough
    # traffic; this flag is the cold-start delay). 0 = hedging off
    "serving_hedge_ms": (0.0, float),
    # default seed of resilience.chaos() fault-point streams
    "chaos_seed": (0, int),
    # brownout degradation ladder: a breached-SLO server degrades
    # best-effort, then batch traffic (shed, capped max_new_tokens,
    # shrunken admission) before interactive traffic, and recovers
    # symmetrically as breaches clear
    "serving_brownout": (True, bool),
    # -- retries (resilience.retry_call, RetryBudget) --
    # the retry deadline in SECONDS, extra attempts, first backoff, and
    # the circuit breaker's failure threshold and reset
    "rpc_deadline": (150.0, float),
    "rpc_retry_times": (3, int),
    "rpc_retry_base_backoff": (0.05, float),
    "rpc_circuit_break_failures": (3, int),
    "rpc_circuit_reset_secs": (5.0, float),
    # process-global retry budget: every initial request deposits this
    # many retry tokens and every retry, hedge or reconnect withdraws
    # one, so retrying is bounded at ~ratio x the offered load and a
    # saturated process sheds instead of amplifying itself. A small
    # time-based reserve keeps isolated failures retryable. < 0
    # disables the budget
    "retry_budget_ratio": (0.1, float),
    # -- training loop --
    # scan fetched outputs and updated state for nan/inf after each step
    # and raise NonFiniteError (Executor.run / run_steps default)
    "check_nan_inf": (False, bool),
    # train_from_dataset: steps per run_steps slab (1 = one run a step)
    "steps_per_run": (1, int),
    # train_from_dataset's fused path: fetch on every N-th slab only
    # (and on print_period slabs and the last)
    "fetch_every_n": (1, int),
    # -- elastic training (train.TrainingSupervisor) --
    # one async full-training-state checkpoint every N slabs
    "checkpoint_every_n_slabs": (16, int),
    # wall-clock budget of the preemption fast checkpoint; a save that
    # misses it is abandoned and the previous verified checkpoint
    # stands. 0 = no bound
    "preempt_deadline_s": (30.0, float),
    # supervised restarts (crash or hang -> reload the newest checkpoint
    # with capped backoff) before RestartBudgetExceeded
    "train_restart_budget": (3, int),
    # model-health monitoring: every N-th supervised slab also fetches
    # the loss, the global grad norm and the update ratio in-graph and
    # evaluates the spike rules; 0 = off (no ops added)
    "train_health_every_n": (0, int),
    # -- multi-slice training (train/slices, passes hier_grad_sync) --
    # hier_allreduce decomposes on a pure dcn_dp x dp mesh:
    # reduce-scatter over dp, all-reduce of the 1/dp shard over dcn_dp,
    # all-gather over dp. False = one all-reduce over dcn_dp x dp (the
    # flat A/B baseline of the same program)
    "dcn_hierarchical": (True, bool),
    # before the first slab of a hierarchical program, check its grad
    # sync against the mesh (parallel.dcn.check_hier_sync) and raise
    # HierarchicalCommsError when it does not decompose or does not pay
    "dcn_assert_hier": (True, bool),
    # SliceSupervisor liveness: a slice whose last heartbeat is older
    # than this many seconds counts one stale observation; membership
    # changes after this many consecutive stale (or fresh)
    # observations, and not within the cooldown of the last change
    "slice_heartbeat_timeout_s": (5.0, float),
    "slice_window": (3, int),
    "slice_cooldown_s": (10.0, float),
    # spike rules: breach when the value exceeds this multiple of its
    # trailing EMA
    "train_loss_spike_ratio": (3.0, float),
    "train_grad_spike_ratio": (10.0, float),
    # micro-batching: a group flushes at this many rows, or when its
    # oldest request has waited batch_timeout_ms
    "serving_max_batch_size": (32, int),
    "serving_batch_timeout_ms": (5.0, float),
    # captured-program cache caps (0 bytes = unbounded)
    "serving_cache_entries": (32, int),
    "serving_cache_bytes": (0, int),
    # -- KV-cached generation --
    # per-layer KV cache length: prompt + max_new_tokens must fit
    # (clamped to the model's max_position)
    "decode_max_len": (2048, int),
    # minimum prefill sequence bucket (power-of-two buckets above it)
    "decode_bucket_min": (16, int),
    # serving decode bank: generation slots stepped together
    "decode_slots": (8, int),
    # tensor-parallel generation: GPTGenerator over the world's tp axis
    # (the Megatron split of gpt.apply_tp_sharding, each rank a pool of
    # its heads), gated by TPCompileGateError; 0/1 = one card
    "serving_tp": (0, int),
    # the gate's replicated-large-param threshold: a parameter held
    # whole on a tp rank is refused at or above this many megabytes
    "shard_audit_replicated_mb": (16.0, float),
    # speculative decoding: draft depth K (a drafter proposes up to K
    # tokens per row, one verify pass scores all K+1 positions,
    # rejection sampling keeps the model-agreed prefix); 0 = off.
    # Greedy output is the same either way
    "decode_spec_k": (0, int),
    # default drafter: "ngram" (prompt lookup) or "model" (a 1-layer
    # draft GPT over the generator's own parameters)
    "decode_spec_mode": ("ngram", str),
    # chunked prefill: serving admission ingests prompts in slices of at
    # most this many tokens, one slice per decode round; 0 = monolithic
    "prefill_chunk_tokens": (0, int),
    # block-granular prefix cache: finished prompts deposit their KV
    # blocks into a refcounted index; a prompt sharing a prefix adopts
    # them (copy-on-write on divergence). Cold entries evict LRU
    "kv_prefix_cache": (False, bool),
    # -- paged KV cache --
    # block-paged decode memory instead of the dense [slots, H, L, D] bank
    "kv_paged": (False, bool),
    # pool element type: fp32, bf16, or int8 with per-(block, head, slot)
    # float32 scales
    "kv_cache_dtype": ("fp32", str),
    "kv_block_size": (16, int),
    # total pool blocks incl. the trash block; 0 = dense-bank equivalent
    # (slots * ceil(max_len / block_size) + 1)
    "kv_pool_blocks": (0, int),
    # cuDNN convolutions (forward, dgrad, wgrad) take deterministic
    # algorithms only: a training step is the same bits run to run, and
    # a replayed step the bits of its eager run. On by default in the
    # port (off in the JAX package, which leaves the algorithms to XLA):
    # it cost bench_resnet50's step nothing measurable on an H100
    # (chip_smoke's cudnn_deterministic_ab), and without it two LeNet
    # runs differ
    "cudnn_deterministic": (True, bool),
    # -- program passes --
    # the executor's pre-lowering pipeline over a clone of the program:
    # "1" = dce,cse,fuse_optimizer; "0" = off (the program runs as
    # built); or a comma-separated pass list, run in canonical order
    "program_passes": ("1", str),
    # program verification: each executor memo miss verifies the user
    # program and every pass's output (framework/analysis.py)
    "verify_passes": (False, bool),
    # byte cap of one fused-optimizer bucket, in megabytes of parameters
    "fuse_optimizer_bucket_mb": (64, int),
    # -- observability (the metrics registry, tracing, the flight
    # recorder, the profiler, the SLO monitor) --
    # fraction of requests that carry a trace context, sampled at the
    # client (serving.Client / tracing.maybe_trace): 0.0 off, 1.0 all
    "trace_sample_rate": (0.01, float),
    # flight recorder ring capacity (recent structured events)
    "flight_recorder_events": (512, int),
    # directory of automatic flight-recorder dumps (an Internal error
    # crossing the serving wire boundary, rate-limited); "" = off
    "flight_recorder_dir": ("", str),
    # measured per-op profiling: 0 off; N >= 1 = every N-th
    # Executor.run of a program also replays it op by op on copies
    # (synced, timed), for observability.last_op_profile()
    "profile_ops": (0, int),
    # the default SLO monitor inside every InferenceServer
    "slo_monitor": (True, bool),
    "slo_poll_s": (0.25, float),
    # default-rule thresholds (0 disables the rule): windowed p99 of the
    # decode loop's step (ms), queue depth over the admission cap, paged
    # pool occupancy, and the decode MFU floor
    "slo_decode_p99_ms": (2000.0, float),
    "slo_queue_ratio": (0.9, float),
    "slo_kvpool_ratio": (0.95, float),
    "slo_mfu_floor": (0.0, float),
    # input-pipeline stall window and the consumer-wait share that flags
    # it (observability.inputstall)
    "dataio_stall_window_s": (1.0, float),
    "dataio_stall_ratio": (0.5, float),
}

_values = {}


def _coerce(raw, typ):
    if typ is bool:
        return str(raw).lower() in ("1", "true", "yes", "on")
    return typ(raw)


def flag(name):
    return _values[name]


def _key(name):
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _DEFS:
        raise ValueError(f"unknown flag {name!r}")
    return key


def get_flags(flags):
    """``{name: value}`` for one name or a list of names."""
    names = [flags] if isinstance(flags, str) else list(flags)
    return {n: _values[_key(n)] for n in names}


def set_flags(flags_dict):
    for n, v in flags_dict.items():
        key = _key(n)
        _values[key] = _coerce(v, _DEFS[key][1])


for _name, (_default, _typ) in _DEFS.items():
    _raw = os.environ.get(f"FLAGS_{_name}")
    _values[_name] = _coerce(_raw, _typ) if _raw is not None else _default
