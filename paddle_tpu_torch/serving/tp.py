"""Tensor-parallel generation behind the batcher and the server: one
leader rank decides, its followers mirror.

Port-only. The JAX package is one controller over a device mesh, so its
``DecodeBatcher`` and ``InferenceServer`` drive a tp generator like any
other. The port is one process a card: every rank of a tp group holds
its shards of the model (``models.gpt.GPT``'s tp form), a pool or bank
of its ``num_heads / tp`` heads and its own captured decode graphs, and
every prefill, chunk, verify and decode step runs collectives over the
group. So every rank must make the same engine calls, with the same
arguments, in the same order, or a collective deadlocks. Requests reach
one rank over the wire at times no other rank sees; that rank (tp index
0, the leader) owns the listener, the queue, admission, priorities,
dedup, brownout, the drafting decision, stats, health and the SLO
monitor, and hands each call to the others before it runs it.

- :class:`Channel`: the leader's descriptors over the gloo group beside
  the NCCL tp group (``parallel.mesh.axis_group("tp", host=True)``), so
  device work never waits behind a pickled object; one broadcast of a
  fixed 8 KiB buffer a batch of descriptors, a second for a larger one
  (a migrated KV payload); a call with no collective in it (admission's
  eviction, prepare, release, the leak sweep, the chunked prefill's
  first and last call) waits and travels with the next call that has
  one, so a decode step is one broadcast. A ``TCPStore`` the leader
  opens carries what the followers report: heartbeats, reload outcomes,
  pool digests.
- :class:`TPLeaderEngine`: a ``GenerationEngine`` whose every call that
  touches the device or the pool (admission's eviction, admit and
  import, the chunked prefill's three calls, prepare, step and verify,
  release and the leak sweep, export, the drafter, apply, reset, the
  watchdog's bank drop, shutdown) sends a descriptor of the call first:
  every input the leader's host chose (slots, tokens, positions, widths,
  sampling, drafts, chunk bounds), never a token a follower would have
  to sample alike. The engine's fault points fire on the leader before
  a call is handed out, so a fault fails a call on every rank alike.
- :class:`TPFollower`: the loop that runs each descriptor's call on its
  own engine. Each descriptor carries how the leader's previous call
  ended and, with ``check_digests``, the leader's ``KVBlockPool.digest``
  before the call: a follower whose outcome or pool differs stops
  (diverged), and the leader counts the group lost.
- Liveness: each follower's heartbeat in the store; the leader's monitor
  reads them for ``health`` and counts a follower lost when its beat
  stops for ``_LOST_AFTER_S``. A tp group that lost a rank is not
  restarted: a call failing past its hand-out (a communicator error) or
  a step tripping the watchdog after it was handed out ends the group,
  and every request in flight or queued fails with
  :class:`TPGroupLostError`. A watchdog trip before the hand-out (the
  leader stalled) drops the bank on every rank and serving goes on.

The serving world is one tp group (``world == tp``); a larger world
would be replicas behind a router (ROADMAP.md Queue 1 item 8b) and
raises. Hot reload: each rank reads the whole-tensor checkpoint and cuts
its shards off the loop (a ``stage`` descriptor; a follower stages on a
thread of its own and reports to the store); any rank's refusal refuses
the reload on every rank before anything is applied; ``apply_params``
is then handed out between steps. KV export gathers every rank's heads
(``kvblocks1``, the single-card layout); import hands each rank its
heads of a whole payload.
"""
import os
import pickle
import threading
import time
from datetime import timedelta

import numpy as np

from ..flags import flag
from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import (CheckpointCorruptError, WatchdogTimeout,
                          maybe_fail)
from .batching import InternalServerError, ServingError
from .engine import GenerationEngine

_INLINE = 8192          # descriptor bytes that fit the one fixed broadcast
_HEARTBEAT_S = 0.25     # a follower's beat period (the monitor's too)
_LOST_AFTER_S = 10.0    # a beat this old loses the group
_STAGE_TIMEOUT_S = 300.0    # every follower reports a reload's staging
_STORE_TIMEOUT_S = 60.0     # a store call, and a digest's reports


class TPGroupLostError(InternalServerError):
    """The serving tp group lost a rank (it died, hung past the watchdog
    or diverged) or its communicator failed mid-call: the requests in
    flight and queued fail with it, and the group is not restarted."""


class TPDivergedError(RuntimeError):
    """A follower's call ended otherwise than the leader's, or its pool
    bookkeeping differs from the leader's: the follower stops."""


def check_serving_world(tp, world=None):
    """Raise unless the launched world is one tp group of ``tp`` ranks:
    a larger world would be replicas behind a router (item 8b)."""
    from ..parallel.mesh import world_size
    n = world_size() if world is None else int(world)
    if n > int(tp):
        raise NotImplementedError(
            f"paddle_tpu_torch: serving a tp={tp} generator in a world of "
            f"{n} ranks: the serving world is one tp group (launch "
            f"--nproc_per_node={tp}); replicas behind a router are not "
            f"ported (ROADMAP.md Queue 1 item 8b)")


def _leader_host(leader_rank):
    eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                     "").split(",") if e]
    if leader_rank < len(eps):
        return eps[leader_rank].rsplit(":", 1)[0]
    return "127.0.0.1"


class Channel:
    """The host side of one tp group: the leader's descriptors over the
    gloo group beside the NCCL one, and a ``TCPStore`` (opened by the
    leader, its address handed out over that group) for what followers
    report. Every rank of the group makes one, together."""

    def __init__(self, mesh):
        import torch
        import torch.distributed as dist
        from ..parallel.mesh import axis_group
        self.mesh = mesh
        self.size = mesh.tp
        self.index = mesh.coords()["tp"]
        self.ranks = mesh.axis_ranks("tp")
        self.leader = self.index == 0
        self.group = axis_group("tp", mesh, host=True)
        if self.group is None:
            raise RuntimeError("tp serving needs the tp group's host (gloo) "
                               "group: build the mesh in a launched world")
        self._buf = torch.zeros(_INLINE + 8, dtype=torch.uint8)
        timeout = timedelta(seconds=_STORE_TIMEOUT_S)
        addr = [None, None]
        if self.leader:
            host = _leader_host(self.ranks[0])
            self._master = dist.TCPStore(host, 0, is_master=True,
                                         wait_for_workers=False,
                                         timeout=timeout)
            addr = [host, self._master.port]
        dist.broadcast_object_list(addr, src=self.ranks[0], group=self.group)
        self.store = self._master if self.leader else dist.TCPStore(
            addr[0], addr[1], is_master=False, timeout=timeout)
        if not self.leader:
            self.beat("ready")

    # -- descriptors ------------------------------------------------------
    def send(self, obj):
        """The leader's side: ``obj`` to every follower, in order."""
        import torch
        import torch.distributed as dist
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        n = len(data)
        head = np.frombuffer(np.int64(n).tobytes(), np.uint8)
        self._buf[:8] = torch.from_numpy(head.copy())
        if n <= _INLINE:
            self._buf[8:8 + n] = torch.frombuffer(bytearray(data),
                                                  dtype=torch.uint8)
        dist.broadcast(self._buf, src=self.ranks[0], group=self.group)
        if n > _INLINE:
            dist.broadcast(torch.frombuffer(bytearray(data),
                                            dtype=torch.uint8),
                           src=self.ranks[0], group=self.group)

    def recv(self):
        """A follower's side: the leader's next object (blocks)."""
        import torch
        import torch.distributed as dist
        dist.broadcast(self._buf, src=self.ranks[0], group=self.group)
        n = int(np.frombuffer(self._buf[:8].numpy().tobytes(), np.int64)[0])
        if n <= _INLINE:
            data = self._buf[8:8 + n].numpy().tobytes()
        else:
            big = torch.empty(n, dtype=torch.uint8)
            dist.broadcast(big, src=self.ranks[0], group=self.group)
            data = big.numpy().tobytes()
        # the bytes come from the group's leader, a rank of this program
        return pickle.loads(data)

    # -- reports ----------------------------------------------------------
    def beat(self, status, count=0):
        self.store.set(f"hb/{self.index}", f"{int(count)} {status}")

    def report(self, key, value):
        self.store.set(f"{key}/{self.index}", str(value))

    def collect(self, key, timeout_s):
        """``{tp index: value}`` every follower reported under ``key``
        (raises when one has not within ``timeout_s``)."""
        keys = [f"{key}/{i}" for i in range(1, self.size)]
        self.store.wait(keys, timedelta(seconds=float(timeout_s)))
        out = {}
        for i, k in enumerate(keys, 1):
            out[i] = self.store.get(k).decode()
            self.store.delete_key(k)
        return out

    def beats(self):
        """``{tp index: (count, status)}`` of the followers' heartbeats
        (None where none was written)."""
        out = {}
        for i in range(1, self.size):
            k = f"hb/{i}"
            if not self.store.check([k]):
                out[i] = None
                continue
            n, _, status = self.store.get(k).decode().partition(" ")
            out[i] = (int(n), status)
        return out


def _req(r, kv=False):
    """The host inputs of a request an engine call reads."""
    d = {"prompt": np.asarray(r.prompt, np.int32).reshape(-1),
         "temperature": float(r.temperature), "top_k": int(r.top_k)}
    if kv:
        d["kv"] = r.kv
        d["first_token"] = int(r.first_token)
    return d


class _Req:
    """A follower's stand-in for a request: what the engine reads."""

    def __init__(self, d):
        self.prompt = d["prompt"]
        self.temperature = d["temperature"]
        self.top_k = d["top_k"]
        self.kv = d.get("kv")
        self.first_token = d.get("first_token")
        self.trace = None


class _Staged:
    """A staged reload on the leader: its shards and the version the
    followers staged theirs under."""

    def __init__(self, version, params):
        self.version = version
        self.params = params


class _MirroredDrafter:
    """A model drafter at the target's tp (> 1): each ``draft`` is handed
    to the followers (its ``generate`` runs collectives)."""

    def __init__(self, engine, inner):
        self.engine = engine
        self.inner = inner
        self.tp = inner.tp

    def draft(self, ctx, k):
        ctx = np.asarray(ctx, np.int32).reshape(-1)
        return self.engine._call("draft", lambda: self.inner.draft(ctx, k),
                                 ctx=ctx, k=int(k))


# exceptions a call raises before any collective, on every rank alike
_CLEAN = (ServingError, ValueError, KeyError)
# calls with no collective in them: their descriptors wait for the next
# call that has one (or for a digest or stop) and travel with it, in
# order, so a decode step costs the followers one broadcast
_DEFERRED = frozenset({"admission_check", "release_slot", "prepare_step",
                       "reclaim_leaks", "start_prefill", "finish_prefill"})


def _config(engine):
    """What the ranks' engines must agree on."""
    pool = engine.pool
    return {"slots": engine.slots, "paged": engine.paged,
            "max_len": engine.max_len, "tp": engine.gen.tp,
            "seed": engine._seed,
            "pool": None if pool is None else (
                pool.dtype, pool.block_size, pool.num_blocks,
                pool.num_heads, pool.prefix_enabled)}


class TPLeaderEngine(GenerationEngine):
    """The leader's ``GenerationEngine``: each call that touches the
    device or the pool is handed to the followers (``channel``) before it
    runs here. ``check_digests``: each in-band descriptor carries this
    pool's digest, which every follower compares with its own.
    ``on_lost``: callbacks of
    the reason, run once when the group is lost. The remaining keywords
    are ``GenerationEngine``'s."""

    leader = True

    def __init__(self, generator, channel, *, check_digests=False, **kw):
        super().__init__(generator, faults=False, **kw)
        self.channel = channel
        self.check_digests = bool(check_digests)
        self.lost = None            # the reason, once the group is lost
        self.on_lost = []
        self._lock = threading.RLock()
        self._prev = None           # how the last in-band call ended
        self._closed = False        # shut down: nothing more is handed out
        self._nest = threading.local()   # depth of handed-out calls running
        self._waiting = []          # deferred descriptors, not yet sent
        self.sends = 0              # broadcasts, and their seconds
        self.send_s = 0.0
        self.local_s = {}           # op -> seconds of the leader's own half
        self._step_desc = None
        self._stage_version = 0
        self._digest_no = 0
        self.calls = {}             # op -> descriptors handed out
        self.handoff_s = 0.0        # decode and verify steps' hand-offs
        self.handoffs = 0
        self._hand("hello", inband=False, config=_config(self))
        self._monitor = _Monitor(self, _HEARTBEAT_S, _LOST_AFTER_S)
        self._monitor.start()

    # -- the hand-out -----------------------------------------------------
    def _lose(self, reason):
        with self._lock:
            if self.lost is not None:
                return
            self.lost = str(reason)
        _flightrec().record("tp_group_lost", reason=str(reason)[:300])
        for fn in list(self.on_lost):
            try:
                fn(self.lost)
            except Exception:  # noqa: BLE001 — every callback runs
                pass

    def lost_error(self):
        """The typed error of a lost group (``lost`` names why)."""
        return TPGroupLostError(f"the serving tp group of {self.gen.tp} "
                                f"ranks is lost: {self.lost}")

    def _hand(self, op, inband=True, **args):
        """Hand ``op``'s descriptor out (under the lock). ``inband``: a call
        of the loop's sequence (it carries how the last one ended and,
        with ``check_digests``, the pool's digest). A call of
        ``_DEFERRED`` waits for the next one that is sent; the ones
        waiting go out with it, in order, in one broadcast."""
        with self._lock:
            if self.lost is not None:
                raise self.lost_error()
            if self._closed:
                raise ServingError(f"the tp engine was shut down: {op!r} "
                                   f"is not handed out")
            desc = {"op": op, "args": args}
            if inband:
                desc["prev"] = self._prev
                if self.check_digests and self.pool is not None:
                    desc["digest"] = self.pool.digest()
            self.calls[op] = self.calls.get(op, 0) + 1
            if inband and op in _DEFERRED:
                self._waiting.append(desc)
                return
            batch, self._waiting = self._waiting + [desc], []
            t0 = time.perf_counter()
            try:
                self.channel.send(batch)
            except Exception as exc:  # noqa: BLE001 — the group is gone
                self._lose(f"handing {op!r} to the followers failed: "
                           f"{type(exc).__name__}: {exc}")
                raise self.lost_error() from exc
            self.send_s += time.perf_counter() - t0
            self.sends += 1

    def _local(self, op, fn):
        """Run the leader's own half of a handed-out call; a failure other
        than a clean refusal leaves the communicator in an unknown state:
        the group is lost."""
        self._nest.depth = getattr(self._nest, "depth", 0) + 1
        t0 = time.perf_counter()
        try:
            out = fn()
        except _CLEAN as exc:
            self._prev = type(exc).__name__
            raise
        except Exception as exc:  # noqa: BLE001 — the group's fault
            self._prev = type(exc).__name__
            if isinstance(exc, TPGroupLostError):
                raise
            self._lose(f"{op!r} failed after it was handed out "
                       f"({type(exc).__name__}: {exc}): the tp group's "
                       f"communicator is in an unknown state")
            raise self.lost_error() from exc
        finally:
            self._nest.depth -= 1
            self.local_s[op] = self.local_s.get(op, 0.0) \
                + time.perf_counter() - t0
        self._prev = None
        return out

    def _call(self, op, fn, **args):
        if getattr(self._nest, "depth", 0):
            # a call made inside a handed-out one (admit releasing its
            # slots on a failure): every follower makes it there too
            return fn()
        self._hand(op, **args)
        return self._local(op, fn)

    # -- the mirrored calls -----------------------------------------------
    def admission_check(self, prompt_len, max_new_tokens, pending_tokens=(),
                        static_only=False):
        base = super().admission_check
        if static_only or self.pool is None:      # reads only
            return base(prompt_len, max_new_tokens, pending_tokens,
                        static_only)
        pending = [int(t) for t in pending_tokens]
        return self._call(
            "admission_check",
            lambda: base(prompt_len, max_new_tokens, pending),
            prompt_len=int(prompt_len), max_new_tokens=int(max_new_tokens),
            pending_tokens=pending)

    def release_slot(self, slot):
        if self.pool is None:
            return
        if self.lost is not None:       # nothing left to mirror to
            GenerationEngine.release_slot(self, slot)
            return
        self._call("release_slot",
                   lambda: GenerationEngine.release_slot(self, slot),
                   slot=int(slot))

    def prepare_step(self, active_pos, widths=None):
        if self.pool is None:
            return {}
        active = {int(s): int(p) for s, p in active_pos.items()}
        wide = None if widths is None else {int(s): int(w)
                                            for s, w in widths.items()}
        return self._call(
            "prepare_step",
            lambda: GenerationEngine.prepare_step(self, active, wide),
            active_pos=active, widths=wide)

    def reclaim_leaks(self, live_slots):
        if self.pool is None:
            return 0
        live = [int(s) for s in live_slots]
        if self.lost is not None:
            return GenerationEngine.reclaim_leaks(self, live)
        return self._call("reclaim_leaks",
                          lambda: GenerationEngine.reclaim_leaks(self, live),
                          live_slots=live)

    def admit(self, requests, slot_ids):
        # the fault points of a prefill fire here, before the hand-out
        maybe_fail("serving.prefill")
        maybe_fail("serving.slot_insert")
        slots = [int(s) for s in slot_ids]
        return self._call(
            "admit", lambda: GenerationEngine.admit(self, requests, slots),
            reqs=[_req(r) for r in requests], slots=slots)

    def start_prefill(self, req, slot):
        return self._call(
            "start_prefill",
            lambda: GenerationEngine.start_prefill(self, req, slot),
            req=_req(req), slot=int(slot),
            chunk=int(flag("prefill_chunk_tokens")))

    def prefill_chunk(self, state):
        return self._call(
            "prefill_chunk",
            lambda: GenerationEngine.prefill_chunk(self, state),
            slot=int(state["slot"]), next=int(state["next"]))

    def finish_prefill(self, state):
        return self._call(
            "finish_prefill",
            lambda: GenerationEngine.finish_prefill(self, state),
            slot=int(state["slot"]))

    def export_slot(self, slot):
        if self.pool is None:
            return super().export_slot(slot)        # the typed refusal
        return self._call("export_slot",
                          lambda: GenerationEngine.export_slot(self, slot),
                          slot=int(slot))

    def admit_imported(self, requests, slot_ids):
        if self.pool is None:
            return super().admit_imported(requests, slot_ids)
        slots = [int(s) for s in slot_ids]
        return self._call(
            "admit_imported",
            lambda: GenerationEngine.admit_imported(self, requests, slots),
            reqs=[_req(r, kv=True) for r in requests], slots=slots)

    def reset(self):
        self._call("reset", lambda: GenerationEngine.reset(self))

    def _drop_bank(self, worker=None):
        with self._lock:
            self._hand("drop_bank")
            GenerationEngine._drop_bank(self, worker)
            self._prev = None

    def make_drafter(self, mode=None, tp=None):
        mode = mode or flag("decode_spec_mode") or "ngram"
        if mode != "model":
            return super().make_drafter(mode)       # host-only: the leader's
        # a model drafter is built on every rank, at the leader's
        # FLAGS_serving_tp: at tp 1 its whole layers are gathered from the
        # shards (a collective)
        tp = max(int(flag("serving_tp") if tp is None else tp), 1)
        drafter = self._call(
            "make_drafter",
            lambda: GenerationEngine.make_drafter(self, mode, tp=tp),
            mode=mode, tp=tp)
        return _MirroredDrafter(self, drafter) if drafter.tp > 1 else drafter

    # -- steps ------------------------------------------------------------
    def step(self, tokens, pos, temperature, top_k, live=None, budget=None):
        self._step_desc = ("step", {
            "tokens": np.ascontiguousarray(tokens, np.int32),
            "pos": np.ascontiguousarray(pos, np.int32),
            "temperature": np.ascontiguousarray(temperature, np.float32),
            "top_k": np.ascontiguousarray(top_k, np.int32),
            "live": None if live is None else np.asarray(live, bool)})
        return super().step(tokens, pos, temperature, top_k, live=live,
                            budget=budget)

    def spec_step(self, tokens, pos, temperature, top_k, drafts, num_draft,
                  live, budget=None):
        self._step_desc = ("spec_step", {
            "tokens": np.ascontiguousarray(tokens, np.int32),
            "pos": np.ascontiguousarray(pos, np.int32),
            "temperature": np.ascontiguousarray(temperature, np.float32),
            "top_k": np.ascontiguousarray(top_k, np.int32),
            "drafts": np.ascontiguousarray(drafts, np.int32),
            "num_draft": np.ascontiguousarray(num_draft, np.int32),
            "live": np.asarray(live, bool)})
        return super().spec_step(tokens, pos, temperature, top_k, drafts,
                                 num_draft, live, budget=budget)

    def _watched(self, fn, budget, what):
        """The step under the watchdog, handed out on the worker after its
        fault point: a trip before the hand-out drops the bank on every
        rank; one after it means a rank hung or died (the group is
        lost)."""
        op, args = self._step_desc
        bank = self._bank_epoch
        handed = [False]
        if self._deposed:
            self._deposed = [d for d in self._deposed if d[0].is_alive()]

        def _work():
            self.bind_thread()
            maybe_fail("serving.decode_step")
            with self._lock:
                if self._bank_epoch != bank:
                    raise ServingError("the decode bank was released while "
                                       "this step waited; it does not run")
                t0 = time.perf_counter()
                self._hand(op, **args)
                self.handoff_s += time.perf_counter() - t0
                self.handoffs += 1
                handed[0] = True
            return self._local(op, fn)

        if not budget:
            return _work()
        try:
            return self._worker.call(_work, budget, what=what)
        except WatchdogTimeout as exc:
            with self._lock:
                if not handed[0]:
                    self._drop_bank(getattr(exc, "thread", None))
                    raise
            self._lose(f"{what} exceeded its {budget}s watchdog after it "
                       f"was handed out: a rank of the tp group hung or died")
            raise self.lost_error() from exc

    def handoff_us_per_step(self):
        return self.handoff_s / self.handoffs * 1e6 if self.handoffs else None

    # -- hot reload -------------------------------------------------------
    def stage_snapshot(self, dirname):
        """Every rank reads and verifies the whole-tensor checkpoint and
        stages its shards (the followers on threads of their own); any
        rank's refusal is raised here, typed, after every rank dropped
        what it staged."""
        self.bind_thread()
        with self._lock:
            self._stage_version += 1
            v = self._stage_version
        self._hand("stage", inband=False, path=str(dirname), version=v)
        err = staged = None
        try:
            staged = GenerationEngine.stage_snapshot(self, dirname)
        except Exception as exc:  # noqa: BLE001 — raised below, typed
            err = exc
        try:
            reports = self.channel.collect(f"stage/{v}",
                                           _STAGE_TIMEOUT_S)
        except Exception as exc:  # noqa: BLE001 — a rank never answered
            self._lose(f"a follower did not stage checkpoint {dirname!r} "
                       f"within {_STAGE_TIMEOUT_S}s: {exc}")
            raise self.lost_error() from exc
        bad = [(i, r) for i, r in sorted(reports.items()) if r != "ok"]
        if err is None and not bad:
            return _Staged(v, staged)
        self._hand("unstage", inband=False, version=v)
        if err is not None:
            raise err
        i, rep = bad[0]
        etype, _, msg = rep.partition("\n")
        cls = {"CheckpointCorruptError": CheckpointCorruptError,
               "CheckpointIncompleteError": CheckpointCorruptError,
               "ValueError": ValueError}.get(etype, RuntimeError)
        text = f"tp rank {i} refused the checkpoint ({etype}): {msg}"
        raise cls(text, path=str(dirname)) \
            if cls is CheckpointCorruptError else cls(text)

    def apply_params(self, staged):
        return self._call(
            "apply_params",
            lambda: GenerationEngine.apply_params(self, staged.params),
            version=staged.version)

    # -- checks and lifecycle ---------------------------------------------
    def pool_digests(self, timeout_s=_STORE_TIMEOUT_S):
        """``[leader's digest, each follower's]`` of the pools' host
        bookkeeping, read at one point of the call sequence: run it on
        the decode loop (``InferenceServer.tp_pool_digests``) or with
        the loop stopped."""
        if self.pool is None:
            return []
        self._digest_no += 1
        k = self._digest_no
        mine = self.pool.digest()
        self._call("digest", lambda: None, no=k)
        got = self.channel.collect(f"digest/{k}", timeout_s)
        return [mine] + [got[i] for i in sorted(got)]

    def liveness(self):
        """Each rank of the group: its world rank, role, and (followers)
        whether its heartbeat is fresh, its age and its status."""
        return self._monitor.snapshot()

    def shutdown(self):
        """End every follower's loop (unless the group is lost) and the
        liveness monitor. Idempotent."""
        self._monitor.stop()
        if self.lost is None and not self._closed:
            try:
                self._call("stop", lambda: None)
            except TPGroupLostError:
                pass
        self._closed = True
        self.stop_worker()


class _Monitor:
    """The leader's liveness monitor: reads the followers' heartbeats
    every ``period_s``; a beat that has not moved for ``lost_after_s``,
    or a follower that reports it diverged or failed, loses the group."""

    def __init__(self, engine, period_s, lost_after_s):
        self.engine = engine
        self.period_s = period_s
        self.lost_after_s = lost_after_s
        self._seen = {}         # tp index -> (count, status, monotonic)
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tp-liveness")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _read(self):
        now = time.monotonic()
        beats = self.engine.channel.beats()
        with self._lock:
            for i, b in beats.items():
                old = self._seen.get(i)
                if b is None:
                    if old is None:
                        self._seen[i] = (-1, "none", now)
                    continue
                if old is None or old[0] != b[0] or old[1] != b[1]:
                    self._seen[i] = (b[0], b[1], now)
            return dict(self._seen), now

    def _run(self):
        while not self._stop.wait(self.period_s):
            if self.engine.lost is not None:
                return
            try:
                seen, now = self._read()
            except Exception as exc:  # noqa: BLE001 — the store is gone
                self.engine._lose(f"the tp group's store failed: {exc}")
                return
            for i, (_, status, t) in seen.items():
                if status.startswith(("diverged", "failed")):
                    self.engine._lose(f"tp rank {i} {status}")
                    return
                if now - t > self.lost_after_s:
                    self.engine._lose(
                        f"tp rank {i}'s heartbeat stopped "
                        f"{now - t:.1f}s ago (it died or its host stalled)")
                    return

    def snapshot(self):
        ch = self.engine.channel
        try:
            seen, now = self._read()
        except Exception:  # noqa: BLE001 — the store is gone: report stale
            now = time.monotonic()
            with self._lock:
                seen = dict(self._seen)
        out = [{"rank": ch.ranks[0], "tp_index": 0, "role": "leader",
                "alive": True}]
        for i in range(1, ch.size):
            cnt, status, t = seen.get(i, (-1, "none", now))
            age = now - t
            out.append({"rank": ch.ranks[i], "tp_index": i,
                        "role": "follower",
                        "alive": self.engine.lost is None
                        and age <= self.lost_after_s
                        and not status.startswith(("diverged", "failed",
                                                   "stopped")),
                        "heartbeat_age_s": round(age, 3),
                        "status": status})
        return out


class TPFollower:
    """A follower rank: runs each call the leader hands out on its own
    ``engine`` (a ``GenerationEngine`` with its fault points off), in
    order, until the leader's ``stop``. ``check_digests`` descriptors
    compare this pool's digest with the leader's; a differing outcome or
    digest stops the loop (``TPDivergedError``). Its heartbeat thread
    writes the store every ``_HEARTBEAT_S``. ``record()`` reports what it
    ran. Fault point: ``serving.tp_follower`` before each call (context
    ``op``, ``n``: the calls handled)."""

    leader = False

    def __init__(self, engine, channel):
        self.engine = engine
        self.channel = channel
        self._prefills = {}         # slot -> chunked prefill state
        self._staged = {}           # version -> staged shards
        self._stagers = {}          # version -> staging thread
        self._drafter = None
        self._outcome = None
        self.calls = {}
        self.digest_checks = 0
        self.refused = []           # reloads this rank refused
        self.error = None
        self.recv_s = 0.0           # blocked waiting for the leader
        self.handle_s = 0.0         # running what it handed out
        self.op_s = {}              # op -> seconds running it
        self._beats = 0
        self._stop_beat = threading.Event()
        self._thread = None
        desc = channel.recv()[0]
        if desc["op"] != "hello":
            raise TPDivergedError(f"the leader's first call is "
                                  f"{desc['op']!r}, not its hello")
        self.config = desc["args"]["config"]
        mine = _config(engine)
        if mine != self.config:
            raise ValueError(f"tp rank {channel.index}'s engine {mine} "
                             f"differs from the leader's {self.config}: "
                             f"every rank builds the engine alike")
        self._beat_thread = threading.Thread(target=self._beat, daemon=True,
                                             name="tp-heartbeat")
        self._beat_thread.start()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        """Run the loop on a thread of its own (``join`` waits)."""
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="tp-follower")
        self._thread.start()
        return self

    def join(self, timeout=None):
        """Wait for the loop to end; returns its error (None: stopped by
        the leader)."""
        if self._thread is not None:
            self._thread.join(timeout)
        return self.error

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def _beat(self):
        while not self._stop_beat.wait(_HEARTBEAT_S):
            self._beats += 1
            try:
                self.channel.beat("ok", self._beats)
            except Exception:  # noqa: BLE001 — the leader's store is gone
                return

    def run(self):
        """The loop: every call the leader hands out, until ``stop``.
        Returns None, or raises what ended it (also kept as ``error``)."""
        status = "stopped"
        try:
            self.engine.bind_thread()
            while True:
                t0 = time.perf_counter()
                batch = self.channel.recv()
                t1 = time.perf_counter()
                self.recv_s += t1 - t0
                for desc in batch:
                    if not self._handle(desc):
                        return None
                self.handle_s += time.perf_counter() - t1
        except BaseException as exc:
            self.error = exc
            status = ("diverged: " if isinstance(exc, TPDivergedError)
                      else "failed: ") + f"{type(exc).__name__}: {exc}"[:300]
            raise
        finally:
            self._stop_beat.set()
            try:
                self.channel.beat(status, self._beats + 1)
            except Exception:  # noqa: BLE001 — the leader's store is gone
                pass
            self.engine.stop_worker()

    def _handle(self, desc):
        op, args = desc["op"], desc["args"]
        n = sum(self.calls.values())
        maybe_fail("serving.tp_follower", op=op, n=n)
        self.calls[op] = self.calls.get(op, 0) + 1
        inband = "prev" in desc
        if inband:
            if desc["prev"] != self._outcome:
                raise TPDivergedError(
                    f"the leader's call before {op!r} ended "
                    f"{desc['prev'] or 'ok'}, this rank's "
                    f"{self._outcome or 'ok'}")
            if "digest" in desc:
                self.digest_checks += 1
                mine = self.engine.pool.digest()
                if mine != desc["digest"]:
                    raise TPDivergedError(
                        f"before {op!r} this rank's pool digest {mine} "
                        f"differs from the leader's {desc['digest']}")
        if op == "stop":
            return False
        t0 = time.perf_counter()
        try:
            getattr(self, "_op_" + op)(**args)
        except Exception as exc:  # noqa: BLE001 — compared with the leader
            if not inband:
                raise
            self._outcome = type(exc).__name__
        else:
            if inband:
                self._outcome = None
        finally:
            self.op_s[op] = self.op_s.get(op, 0.0) + time.perf_counter() - t0
        return True

    # -- the calls --------------------------------------------------------
    def _op_admission_check(self, prompt_len, max_new_tokens,
                            pending_tokens):
        self.engine.admission_check(prompt_len, max_new_tokens,
                                    pending_tokens)

    def _op_release_slot(self, slot):
        self._prefills.pop(slot, None)
        self.engine.release_slot(slot)

    def _op_prepare_step(self, active_pos, widths):
        self.engine.prepare_step(active_pos, widths)

    def _op_reclaim_leaks(self, live_slots):
        self.engine.reclaim_leaks(live_slots)

    def _op_admit(self, reqs, slots):
        self.engine.admit([_Req(r) for r in reqs], slots)

    def _op_admit_imported(self, reqs, slots):
        self.engine.admit_imported([_Req(r) for r in reqs], slots)

    def _op_start_prefill(self, req, slot, chunk):
        st = self.engine.start_prefill(_Req(req), slot)
        st["chunk"] = chunk
        self._prefills[slot] = st

    def _op_prefill_chunk(self, slot, next):
        st = self._prefills[slot]
        if st["next"] != next:
            raise TPDivergedError(f"slot {slot}'s chunked prefill is at "
                                  f"{st['next']}, the leader's at {next}")
        self.engine.prefill_chunk(st)

    def _op_finish_prefill(self, slot):
        self.engine.finish_prefill(self._prefills.pop(slot))

    def _op_step(self, tokens, pos, temperature, top_k, live):
        self.engine.step(tokens, pos, temperature, top_k, live=live)

    def _op_spec_step(self, tokens, pos, temperature, top_k, drafts,
                      num_draft, live):
        self.engine.spec_step(tokens, pos, temperature, top_k, drafts,
                              num_draft, live)

    def _op_export_slot(self, slot):
        self.engine.export_slot(slot)

    def _op_reset(self):
        self._prefills.clear()
        self.engine.reset()

    def _op_drop_bank(self):
        self.engine._drop_bank(None)

    def _op_make_drafter(self, mode, tp):
        d = self.engine.make_drafter(mode, tp=tp)
        # a tp-1 drafter drafts on the leader alone
        self._drafter = d if d.tp > 1 else None

    def _op_draft(self, ctx, k):
        self._drafter.draft(ctx, k)

    def _op_digest(self, no):
        self.channel.report(f"digest/{no}", self.engine.pool.digest())

    def _op_stage(self, path, version):
        def work():
            try:
                self.engine.bind_thread()
                staged = self.engine.stage_snapshot(path)
            except Exception as exc:  # noqa: BLE001 — reported, typed
                self.refused.append({"version": version,
                                     "etype": type(exc).__name__,
                                     "error": str(exc)})
                self.channel.report(f"stage/{version}",
                                    f"{type(exc).__name__}\n{exc}")
                return
            self._staged[version] = staged
            self.channel.report(f"stage/{version}", "ok")
        # one staged reload at a time: a newer one replaces the older
        self._staged.clear()
        t = threading.Thread(target=work, daemon=True, name="tp-stage")
        self._stagers = {version: t}
        t.start()

    def _op_unstage(self, version):
        t = self._stagers.pop(version, None)
        if t is not None:
            t.join()
        self._staged.pop(version, None)

    def _op_apply_params(self, version):
        t = self._stagers.pop(version, None)
        if t is not None:
            t.join()
        self.engine.apply_params(self._staged.pop(version))

    def record(self):
        """What this follower ran: calls by op, digest checks, refused
        reloads and the error that ended it (None: the leader's stop)."""
        return {"calls": dict(self.calls), "digest_checks": self.digest_checks,
                "recv_s": self.recv_s, "handle_s": self.handle_s,
                "op_s": dict(self.op_s),
                "refused": list(self.refused),
                "error": None if self.error is None
                else f"{type(self.error).__name__}: {self.error}"}


def tp_generation_engine(generator, *, check_digests=False, **kw):
    """The serving engine of this rank of ``generator``'s tp group: every
    rank calls it, with the same arguments (the remaining keywords are
    ``GenerationEngine``'s). The leader (tp index 0) gets a
    :class:`TPLeaderEngine` (drive it with a ``DecodeBatcher`` and
    ``shutdown()`` it), a follower a :class:`TPFollower` (``run()`` it,
    or ``start()`` and ``join()``)."""
    check_serving_world(generator.tp)
    stats = kw.pop("stats", None)           # the leader's sink only
    if generator.tp == 1:
        raise ValueError("tp_generation_engine serves a tensor-parallel "
                         "generator (tp > 1); at tp 1 use GenerationEngine")
    channel = Channel(generator.mesh)
    if channel.leader:
        return TPLeaderEngine(generator, channel,
                              check_digests=check_digests, stats=stats,
                              **kw)
    return TPFollower(GenerationEngine(generator, faults=False, **kw),
                      channel)
