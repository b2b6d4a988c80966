"""Static-graph persistence of the port: save/load vars, params and
persistables, the inference model, and the single-file ``save``/``load``.

Counterpart of ``paddle_tpu/io.py``, in the same on-disk format, so a
directory either package writes loads in the other: one ``.npy`` per var
(or one ``.npz`` when ``filename`` is given) plus ``__meta__.json`` with
each var's exact dtype (bfloat16 is stored as its uint16 view) and the
extra state, and a ``_manifest.json`` with every file's sha256 and size,
written last. Every file goes to a temp path, is fsynced and renamed
into place; a load checks each file it trusts against the manifest and
raises :class:`CheckpointCorruptError` naming the file.

Loaded tensors go to the executor's device (``executor=None`` is the
GPU, as everywhere in the port) in the var's declared dtype.

The RNG extra: the JAX package saves its threefry key (uint32 words)
under ``@RNG_KEY@``; the port's scope holds an integer seed under
``@RNG_SEED@`` and saves it there as an int64 array. On load the port
takes its own seed when the directory has one, else folds the JAX key's
words into a seed through ``splitmix64``: a resumed run is
deterministic, not the JAX run's stream. The JAX package ignores the
port's extra.

The exact-resume half: :func:`save_checkpoint` writes every
persistable (params, optimizer state, LR and step counters), the run
seed and a ``train_state.json`` under one manifest;
:func:`load_checkpoint` refuses a directory that lacks part of that
state (``CheckpointIncompleteError`` naming the missing optimizer
state) before it touches the scope. A checkpoint carries the run seed
under ``@RNG_SEED@`` and, for the JAX package's strict load, a threefry
key made of the seed's two 32-bit halves under ``@RNG_KEY@``; the port
loads its own seed back, and folds a JAX checkpoint's key
(:func:`fold_jax_key`). :class:`CheckpointSaver` keeps numbered
checkpoints, each staged in a ``.tmp`` directory and committed by an
atomic rename (``"io.commit"`` is its fault point), prunes to
``max_to_keep``, and saves in the background (``save_async``): the
scope is gathered to host copies before ``save_async`` returns, so a
step that runs meanwhile (a captured step writes its tensors in place)
cannot reach the snapshot.

In a data-parallel world (``parallel.mesh``) every rank holds the same
state, so each save writes one copy, from rank 0, and every rank waits
for it (a rank other than 0 writes nothing; its ``CheckpointSaver.save``
returns the number rank 0 committed, its ``save_async`` None). A save
that fails on rank 0 raises on every rank. Every rank loads. Under
tensor parallelism the scope holds each rank's shards: a save first
gathers them to whole tensors on every rank (``parallel.tp.gathered``),
so the files are the single-card format, which loads on one card and in
the JAX package; a load puts whole values in the scope, and the next run
of the tp program cuts each rank's shard out of them.
"""
import functools
import hashlib
import inspect
import json
import os
import shutil
import threading

import numpy as np
import torch

from .device import resolve_device
from .framework.core import Parameter, Program, Variable
from .framework.dtype import torch_dtype
from .framework.executor import RNG_STATE_NAME, global_scope
from .framework.lowering import splitmix64
from .resilience import CheckpointCorruptError, CheckpointIncompleteError
from .resilience import maybe_fail as _maybe_fail

_META_FILE = "__meta__.json"
TRAIN_STATE_FILE = "train_state.json"
_MODEL_FILE = "__model__"
_MANIFEST_FILE = "_manifest.json"
# the JAX package's name for its PRNG key in the scope and the meta extras
JAX_RNG_KEY_NAME = "@RNG_KEY@"
_MASK64 = (1 << 64) - 1

__all__ = ["CheckpointCorruptError", "CheckpointIncompleteError",
           "CheckpointSaver", "TRAIN_STATE_FILE", "is_parameter",
           "is_persistable", "load", "load_checkpoint",
           "load_inference_model", "load_params", "load_persistables",
           "load_vars", "save", "save_checkpoint", "save_inference_model",
           "save_params", "save_persistables", "save_vars",
           "verify_checkpoint"]


# ---------------------------------------------------------------------------
# one writer in a data-parallel world
# ---------------------------------------------------------------------------

_writing = threading.local()


def _one_writer(follow=None):
    """Decorator of a save: in a launched world rank 0 runs it, then every
    rank learns whether it failed (:func:`mesh.any_failed`, which all
    ranks reach; only the outermost save of a nested call does). A failed
    save raises on every rank: rank 0 its own error, the others
    ``RuntimeError``. Otherwise the other ranks return
    ``follow(*args)`` (None by default). Outside a world the save just
    runs."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from .parallel import mesh
            from .parallel.tp import gathered
            if getattr(_writing, "depth", 0) or not mesh.is_initialized():
                return fn(*args, **kwargs)
            scope = sig.bind(*args, **kwargs).arguments.get("scope") \
                or global_scope()
            out, err = None, None
            _writing.depth = 1
            try:
                with gathered(scope):          # every rank: tp shards
                    if mesh.rank() == 0:
                        out = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — told to all ranks
                err = e
            finally:
                _writing.depth = 0
            if mesh.any_failed(err is not None):
                if err is not None:
                    raise err
                raise RuntimeError(f"{fn.__qualname__} failed on rank 0, "
                                   f"which writes for the world: nothing "
                                   f"was saved")
            if mesh.rank() != 0 and follow is not None:
                out = follow(*args, **kwargs)
            return out
        return wrapper
    return deco


def _is_writer():
    from .parallel import mesh
    return mesh.rank() == 0


# ---------------------------------------------------------------------------
# durable writes + manifest integrity
# ---------------------------------------------------------------------------

class _Sha256Writer:
    """File-object proxy that sha256s bytes in flight. A writer that
    seeks (``np.savez`` rewriting zip headers) makes the stream hash
    diverge from the file; ``hexdigest()`` then returns None and the
    manifest hashes that file from disk."""

    def __init__(self, f):
        self._f = f
        self._h = hashlib.sha256()
        self._linear = True

    def write(self, b):
        self._h.update(b)
        return self._f.write(b)

    def seek(self, *args, **kwargs):
        self._linear = False
        return self._f.seek(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def hexdigest(self):
        return self._h.hexdigest() if self._linear else None


def _fsync_write(path, write_fn):
    """Crash-safe file write: temp path, write, flush + fsync, atomic
    rename. Returns the content sha256 (None if ``write_fn`` seeked).
    ``io.fsync_write``, ``io.fsync`` and ``io.rename`` are its fault
    points (``resilience.fault_injection``)."""
    _maybe_fail("io.fsync_write", path=path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        w = _Sha256Writer(f)
        write_fn(w)
        f.flush()
        _maybe_fail("io.fsync", path=path)
        os.fsync(f.fileno())
    _maybe_fail("io.rename", path=path)
    os.replace(tmp, path)
    return w.hexdigest()


def _fsync_dir(dirname):
    """Make the renames durable (a directory entry needs a directory
    fsync)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256_file(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _write_manifest(dirname, files, meta, preserve_existing=False,
                    digests=None):
    """Commit record, written last: per-file sha256 and size, per-var
    dtype and shape. ``preserve_existing`` keeps earlier entries for
    other files still on disk; ``digests`` carries hashes computed while
    writing (files without one are hashed from disk)."""
    kept = {}
    if preserve_existing:
        try:
            prev = _read_manifest(dirname) or {}
        except CheckpointCorruptError:
            prev = {}
        kept = {rel: entry for rel, entry in prev.get("files", {}).items()
                if rel not in files
                and os.path.exists(os.path.join(dirname, rel))}

    def _sha(rel):
        return (digests or {}).get(rel) or \
            _sha256_file(os.path.join(dirname, rel))

    manifest = {
        "version": 1,
        "files": {**kept,
                  **{rel: {"sha256": _sha(rel),
                           "bytes":
                           os.path.getsize(os.path.join(dirname, rel))}
                     for rel in files}},
        "vars": meta.get("vars", {}),
        "extra": meta.get("extra", {}),
    }
    _fsync_write(os.path.join(dirname, _MANIFEST_FILE),
                 lambda f: f.write(json.dumps(manifest, indent=1).encode()))
    _fsync_dir(dirname)


def _read_manifest(dirname):
    path = os.path.join(dirname, _MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {path!r} is unreadable: {e}", path=path)


def _verify_against_manifest(dirname, rel, manifest):
    """Hash-check one file the load is about to trust; files the
    manifest does not list pass."""
    entry = (manifest or {}).get("files", {}).get(rel)
    if entry is None:
        return
    path = os.path.join(dirname, rel)
    if not os.path.exists(path):
        raise CheckpointCorruptError(
            f"checkpoint file {rel!r} is listed in the manifest but "
            f"missing from {dirname!r}", path=path)
    size = os.path.getsize(path)
    if size != entry.get("bytes", size):
        raise CheckpointCorruptError(
            f"checkpoint file {rel!r} in {dirname!r} is {size} bytes, "
            f"manifest says {entry['bytes']}: truncated or partially "
            f"written", path=path)
    digest = _sha256_file(path)
    if digest != entry["sha256"]:
        raise CheckpointCorruptError(
            f"checkpoint file {rel!r} in {dirname!r} fails its integrity "
            f"check (sha256 {digest[:12]}... != manifest "
            f"{entry['sha256'][:12]}...): the checkpoint is corrupt",
            path=path)


def verify_checkpoint(dirname):
    """Hash-check every manifest-listed file under ``dirname``. Returns
    the manifest, or None when the directory has none."""
    manifest = _read_manifest(dirname)
    if manifest is None:
        return None
    for rel in manifest.get("files", {}):
        _verify_against_manifest(dirname, rel, manifest)
    return manifest


def _escape(name):
    return name.replace("/", "%2F").replace(os.sep, "%2F")


def _storable(value, copy=False):
    """(numpy array to store, dtype tag) of a scope value. bfloat16 has
    no numpy dtype: it is stored as its uint16 view under the tag
    ``bfloat16``, as the JAX package stores it. A CPU tensor's array
    shares its memory unless ``copy``; a device tensor's is a host copy
    made before this returns."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if copy and t.device.type == "cpu":
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.array(value, copy=True) if copy else np.asarray(value)
    return arr, str(arr.dtype)


def _restore(arr, tag, device, dtype=None):
    """A stored array back as a tensor on ``device``: ``tag`` is the
    saved dtype; ``dtype`` (the program var's declared type), when
    given, is the tensor's type."""
    if tag == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        a = np.array(arr)            # a writable copy for torch
        if str(a.dtype) != tag:
            a = a.astype(tag)
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(device)


def _device_of(executor):
    return executor.device if executor is not None else resolve_device(None)


def _collect_arrays(scope, var_list, extra_state=None, copy=False):
    """Scope values of ``var_list`` (+ named extra state) as
    ``({name: storable array}, meta)``; ``copy``: arrays that share no
    memory with the scope (a snapshot)."""
    arrays, meta = {}, {"vars": {}, "extra": {}}
    for var in var_list:
        val = scope.find_var(var.name)
        if val is None:
            raise RuntimeError(
                f"variable {var.name!r} has no value in the scope: run the "
                f"startup program (and any training) before saving")
        arr, tag = _storable(val, copy)
        arrays[var.name] = arr
        meta["vars"][var.name] = {"dtype": tag, "shape": list(arr.shape)}
    for name, val in (extra_state or {}).items():
        arr, tag = _storable(val, copy)
        arrays[name] = arr
        meta["extra"][name] = {"dtype": tag}
    return arrays, meta


def _rng_extra(scope):
    seed = scope.find_var(RNG_STATE_NAME)
    return {} if seed is None \
        else {RNG_STATE_NAME: np.array([int(seed)], np.int64)}


def _checkpoint_rng_extra(scope):
    """The run seed, and the JAX package's key for it: a threefry key
    whose two uint32 words are the seed's high and low halves (the JAX
    package's strict ``load_checkpoint`` requires a key)."""
    extra = _rng_extra(scope)
    if extra:
        seed = int(extra[RNG_STATE_NAME][0]) & _MASK64
        extra[JAX_RNG_KEY_NAME] = np.array(
            [seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    return extra


def fold_jax_key(words):
    """The port's run seed for a JAX PRNG key (its raw uint32 words):
    each word is folded in through ``splitmix64``, so one key always
    gives one seed."""
    x = 0
    for w in np.asarray(words).astype(np.uint32).ravel():
        x = splitmix64(((x << 32) | int(w)) & _MASK64)
    return x


def _restore_rng(scope, extras):
    seed = extras.get(RNG_STATE_NAME)
    if seed is not None:
        scope.set(RNG_STATE_NAME,
                  int(np.asarray(seed.cpu()).reshape(-1)[0]))
        return
    key = extras.get(JAX_RNG_KEY_NAME)
    if key is not None:
        scope.set(RNG_STATE_NAME, fold_jax_key(key.cpu().numpy()))


def _resolve_vars(main_program, vars=None, predicate=None):
    if main_program is None:
        from .framework.core import default_main_program
        main_program = default_main_program()
    if vars is not None:
        return main_program, [
            v if isinstance(v, Variable)
            else main_program.global_block().var(str(v)) for v in vars]
    pred = predicate or (lambda v: True)
    return main_program, [v for v in main_program.list_vars() if pred(v)]


def is_persistable(var):
    """Persistable and not a feed/fetch/reader slot."""
    return bool(var.persistable) and var.type not in ("reader", "raw")


def is_parameter(var):
    return isinstance(var, Parameter) or getattr(var, "is_parameter", False)


# ---------------------------------------------------------------------------
# save/load vars
# ---------------------------------------------------------------------------

def _merged_meta(dirname, meta):
    """A prior save's ``__meta__`` entries merged under the new save's,
    so programs sharing one directory keep each other's records."""
    path = os.path.join(dirname, _META_FILE)
    if not os.path.exists(path):
        return meta
    try:
        with open(path) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        return meta
    merged = dict(meta)
    merged["vars"] = {**prev.get("vars", {}), **meta.get("vars", {})}
    merged["extra"] = {**prev.get("extra", {}), **meta.get("extra", {})}
    return merged


def _write_meta(dirname, meta):
    return _fsync_write(os.path.join(dirname, _META_FILE),
                        lambda f: f.write(json.dumps(meta,
                                                     indent=1).encode()))


def _write_array_dir(dirname, arrays, meta, manifest_extra=None):
    """One ``.npy`` per array, the meta and the manifest: the one writer
    of ``save_vars`` and of ``CheckpointSaver``'s background save, so
    the two cannot drift apart. ``manifest_extra``: sibling files
    already written (``train_state.json``) that the manifest covers
    too."""
    meta = _merged_meta(dirname, meta)
    digests = {}
    for name, arr in arrays.items():
        rel = _escape(name) + ".npy"
        digests[rel] = _fsync_write(
            os.path.join(dirname, rel),
            lambda f, _a=arr: np.save(f, _a, allow_pickle=False))
    digests[_META_FILE] = _write_meta(dirname, meta)
    _write_manifest(dirname, list(digests) + list(manifest_extra or ()),
                    meta, preserve_existing=True, digests=digests)


@_one_writer()
def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None,
              extra_state=None, _manifest_extra=None):
    """Write the scope values of the selected vars under ``dirname``:
    one ``.npy`` each, or one ``.npz`` named ``filename``. ``executor``
    is accepted for API parity; persistence is host-side."""
    scope = scope or global_scope()
    main_program, var_list = _resolve_vars(main_program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    arrays, meta = _collect_arrays(scope, var_list, extra_state)
    if filename is None:
        _write_array_dir(dirname, arrays, meta,
                         manifest_extra=_manifest_extra)
        return
    meta = _merged_meta(dirname, meta)
    # through a file object the name stays exact (np.savez appends
    # ".npz" to a bare path); the loader accepts both
    digests = {filename: _fsync_write(
        os.path.join(dirname, filename),
        lambda f: np.savez(
            f, **{_escape(n): a for n, a in arrays.items()}))}
    digests[_META_FILE] = _write_meta(dirname, meta)
    _write_manifest(dirname, list(digests) + list(_manifest_extra or ()),
                    meta, preserve_existing=True, digests=digests)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Read saved arrays into the scope, on the executor's device, each
    in its var's declared dtype. The whole restore is staged and checked
    first: a missing or unreadable file raises and leaves the scope
    untouched. Returns the extra state (e.g. the RNG seed) as tensors on
    the CPU."""
    scope = scope or global_scope()
    device = _device_of(executor)
    main_program, var_list = _resolve_vars(main_program, vars, predicate)
    manifest = _read_manifest(dirname)
    meta_path = os.path.join(dirname, _META_FILE)
    meta = {"vars": {}, "extra": {}}
    if os.path.exists(meta_path):
        if manifest is not None:
            _verify_against_manifest(dirname, _META_FILE, manifest)
        with open(meta_path) as f:
            meta = json.load(f)

    unreadable = {}                       # file -> reason
    if filename is not None:
        zpath, rel = os.path.join(dirname, filename), filename
        if not zpath.endswith(".npz") and not os.path.exists(zpath):
            zpath, rel = zpath + ".npz", filename + ".npz"
        if manifest is not None:
            _verify_against_manifest(dirname, rel, manifest)
        archive = np.load(zpath, allow_pickle=False)

        def _read(name):
            key = _escape(name)
            return archive[key] if key in archive.files else None
    else:
        def _read(name):
            rel = _escape(name) + ".npy"
            p = os.path.join(dirname, rel)
            if not os.path.exists(p):
                return None
            if manifest is not None:
                _verify_against_manifest(dirname, rel, manifest)
            try:
                return np.load(p, allow_pickle=False)
            except (OSError, ValueError) as e:
                unreadable[rel] = f"{type(e).__name__}: {e}"
                return None

    staged, missing = {}, []
    for var in var_list:
        arr = _read(var.name)
        if arr is None:
            missing.append(var.name)
            continue
        tag = meta["vars"].get(var.name, {}).get("dtype", str(arr.dtype))
        staged[var.name] = (arr, tag, var.dtype)
    extras = {}
    for name, info in meta.get("extra", {}).items():
        arr = _read(name)
        if arr is not None:
            extras[name] = _restore(arr, info.get("dtype", str(arr.dtype)),
                                    "cpu")
    if missing or unreadable:
        detail = []
        if missing:
            detail.append(f"{len(missing)} variable(s) have no saved "
                          f"value: {', '.join(sorted(missing))}")
        if unreadable:
            detail.append("unreadable file(s): " + "; ".join(
                f"{k} ({v})" for k, v in sorted(unreadable.items())))
        raise RuntimeError(
            f"checkpoint restore from {dirname!r} is incomplete: "
            + " | ".join(detail) + ". The scope was left untouched.")
    for name, (arr, tag, dtype) in staged.items():
        scope.set(name, _restore(arr, tag, device, dtype))
    return extras


# ---------------------------------------------------------------------------
# params / persistables
# ---------------------------------------------------------------------------

@_one_writer()
def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_vars(executor, dirname, main_program=main_program,
              predicate=is_parameter, filename=filename, scope=scope)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program=main_program,
              predicate=is_parameter, filename=filename, scope=scope)


@_one_writer()
def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    """Params, optimizer accumulators, LR and step counters, and the
    run seed."""
    scope = scope or global_scope()
    save_vars(executor, dirname, main_program=main_program,
              predicate=is_persistable, filename=filename, scope=scope,
              extra_state=_rng_extra(scope))


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    scope = scope or global_scope()
    extras = load_vars(executor, dirname, main_program=main_program,
                       predicate=is_persistable, filename=filename,
                       scope=scope)
    _restore_rng(scope, extras)


# ---------------------------------------------------------------------------
# the full training state (exact resume)
# ---------------------------------------------------------------------------

@_one_writer()
def save_checkpoint(executor, dirname, main_program=None, scope=None,
                    train_state=None):
    """The full training state into ``dirname``: every persistable
    (params, optimizer state, LR and step counters), the run seed and,
    when given, ``train_state`` (the dataset cursor or slab index, as
    ``train_state.json``), all of it under the manifest, so a torn file
    anywhere fails the load instead of diverging the resume."""
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    extra = []
    if train_state is not None:
        _fsync_write(os.path.join(dirname, TRAIN_STATE_FILE),
                     lambda f: f.write(json.dumps(train_state,
                                                  indent=1).encode()))
        extra.append(TRAIN_STATE_FILE)
    save_vars(executor, dirname, main_program=main_program,
              predicate=is_persistable, scope=scope,
              extra_state=_checkpoint_rng_extra(scope),
              _manifest_extra=extra)


def _raise_incomplete(dirname, main_program, missing):
    gb = main_program.global_block()
    opt = sorted(n for n in missing
                 if getattr(gb.vars.get(n), "is_optimizer_state", False))
    what = (f"optimizer state for {len(opt)} variable(s) "
            f"(e.g. {opt[0]!r})" if opt else
            f"{len(missing)} persistable variable(s) "
            f"(e.g. {sorted(missing)[0]!r})")
    raise CheckpointIncompleteError(
        f"checkpoint {dirname!r} is missing {what}: it looks like a "
        f"params-only save, and resuming from it would silently reset "
        f"the missing state. Use io.load_params for a params-only "
        f"restore, or re-save with io.save_checkpoint/save_persistables "
        f"for exact resume.", path=dirname, missing=sorted(missing))


def load_checkpoint(executor, dirname, main_program=None, scope=None,
                    strict=True, filename=None):
    """Restore a :func:`save_checkpoint` (or a full
    ``save_persistables``) directory for exact resume; returns its
    ``train_state`` (None when it has none). ``filename`` names a
    single-archive save. A directory without some persistable (a
    params-only save) or, under ``strict``, without the run's RNG
    record raises :class:`CheckpointIncompleteError` before the scope is
    touched. The restored tensors are new scope values: a captured step
    bound to ``scope`` copies them in on its next slab."""
    scope = scope or global_scope()
    main_program, var_list = _resolve_vars(main_program, None,
                                           is_persistable)
    if filename is None:
        missing = [v.name for v in var_list
                   if not os.path.exists(
                       os.path.join(dirname, _escape(v.name) + ".npy"))]
        if missing:
            _raise_incomplete(dirname, main_program, missing)
    if strict:
        meta_path = os.path.join(dirname, _META_FILE)
        extras = {}
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    extras = json.load(f).get("extra", {})
            except (OSError, ValueError) as e:
                raise CheckpointCorruptError(
                    f"checkpoint meta {meta_path!r} is unreadable: {e}",
                    path=meta_path)
        if RNG_STATE_NAME not in extras and JAX_RNG_KEY_NAME not in extras:
            raise CheckpointIncompleteError(
                f"checkpoint {dirname!r} has no RNG stream record in its "
                f"__meta__ extras: resuming would replay a reseeded "
                f"random stream (dropout) and diverge from the "
                f"uninterrupted run. Re-save with io.save_checkpoint, or "
                f"pass strict=False to accept the divergence.",
                path=dirname, missing=[RNG_STATE_NAME])
    try:
        extras = load_vars(executor, dirname, main_program=main_program,
                           predicate=is_persistable, scope=scope,
                           filename=filename)
    except RuntimeError as e:
        # load_vars checks the whole restore before it touches the scope
        # and names every missing var
        if "incomplete" not in str(e) or \
                isinstance(e, CheckpointCorruptError):
            raise
        missing = [v.name for v in var_list if v.name in str(e)]
        _raise_incomplete(dirname, main_program,
                          missing or [v.name for v in var_list])
    _restore_rng(scope, extras)
    state_path = os.path.join(dirname, TRAIN_STATE_FILE)
    if not os.path.exists(state_path):
        return None
    _verify_against_manifest(dirname, TRAIN_STATE_FILE,
                             _read_manifest(dirname))
    with open(state_path) as f:
        return json.load(f)


class CheckpointSaver:
    """Numbered training checkpoints with retention and background
    saves. Each save writes ``<dirname>/<prefix><n>`` (every persistable
    and the run seed, manifest-checked on load) into a ``.tmp`` staging
    directory and commits it by an atomic directory rename, so no reader
    sees a half-written checkpoint; ``max_to_keep`` prunes the oldest
    after each commit (None keeps all). ``save_async`` gathers the scope
    to host copies before it returns and writes, hashes, fsyncs and
    renames on a thread; ``wait()`` joins the pending saves and raises
    the first failure. One saver writes a directory: numbers are
    reserved in the process, and stale ``.tmp`` entries are removed."""

    def __init__(self, dirname, max_to_keep=5,
                 prefix="__paddle_checkpoint__"):
        self.dirname = dirname
        self.max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self.prefix = prefix
        self._pending = []
        self._errors = []
        self._lock = threading.Lock()
        # numbers handed out by _stage() and not committed yet: two
        # back-to-back save_async calls must not share a staging dir
        self._reserved = set()
        # numbers whose in-flight save was abandoned: _commit drops them
        self._abandoned = set()
        self._gc_stale_temps()

    # -- numbering --------------------------------------------------------
    def checkpoint_numbers(self):
        if not os.path.isdir(self.dirname):
            return []
        out = []
        for d in os.listdir(self.dirname):
            if not d.startswith(self.prefix) or d.endswith(".tmp"):
                continue
            try:
                out.append(int(d[len(self.prefix):]))
            except ValueError:
                continue
        return sorted(out)

    def _path(self, no):
        return os.path.join(self.dirname, f"{self.prefix}{no}")

    def latest(self):
        nums = self.checkpoint_numbers()
        return (nums[-1], self._path(nums[-1])) if nums else (None, None)

    # -- saving -----------------------------------------------------------
    @_one_writer(follow=lambda self, *a, **k: self.latest()[0])
    def save(self, executor, main_program=None, scope=None,
             extra_files=None):
        """A synchronous numbered save; returns its number."""
        no, stage = self._stage()
        self._write(no, stage, executor, main_program, scope, extra_files)
        return no

    @_one_writer()
    def save_async(self, executor, main_program=None, scope=None,
                   extra_files=None):
        """Snapshot now (host copies of every persistable, made before
        this returns), write in the background. Returns the checkpoint
        number; call :meth:`wait` before relying on the files."""
        scope = scope or global_scope()
        main_program, var_list = _resolve_vars(main_program, None,
                                               is_persistable)
        arrays, meta = _collect_arrays(scope, var_list,
                                       _checkpoint_rng_extra(scope),
                                       copy=True)
        no, stage = self._stage()

        def _bg():
            try:
                self._write_arrays(no, stage, arrays, meta, extra_files)
            except Exception as exc:  # noqa: BLE001 — raised in wait()
                with self._lock:
                    self._errors.append(exc)

        t = threading.Thread(target=_bg, daemon=True,
                             name=f"ckpt-save-{no}")
        with self._lock:
            self._pending.append(t)
        t.start()
        return no

    def wait(self):
        """Join the pending background saves; raise the first failure."""
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()
        with self._lock:
            if self._errors:
                exc = self._errors[0]
                self._errors = []
                raise exc

    # -- restore ----------------------------------------------------------
    def restore(self, executor, main_program=None, scope=None):
        """Load the newest checkpoint; returns its number (None when the
        directory holds none)."""
        no, path = self.latest()
        if no is None:
            return None
        load_persistables(executor, path, main_program=main_program,
                          scope=scope)
        return no

    # -- internals --------------------------------------------------------
    def _stage(self):
        os.makedirs(self.dirname, exist_ok=True)
        with self._lock:
            nums = self.checkpoint_numbers()
            floor = max(nums[-1] if nums else -1,
                        max(self._reserved, default=-1))
            no = floor + 1
            self._reserved.add(no)
        stage = self._path(no) + ".tmp"
        if os.path.isdir(stage):
            shutil.rmtree(stage, ignore_errors=True)
        return no, stage

    def _release(self, no):
        with self._lock:
            self._reserved.discard(no)

    @staticmethod
    def _write_extra_files(stage, extra_files):
        """The side JSON files (``train_state.json``), written before the
        arrays' manifest, which covers them. Returns their names."""
        names = []
        for rel, payload in (extra_files or {}).items():
            _fsync_write(os.path.join(stage, rel),
                         lambda f, _p=payload: f.write(
                             json.dumps(_p).encode()))
            names.append(rel)
        return names

    def _write(self, no, stage, executor, main_program, scope,
               extra_files):
        try:
            os.makedirs(stage, exist_ok=True)
            names = self._write_extra_files(stage, extra_files)
            scope_ = scope or global_scope()
            save_vars(executor, stage, main_program=main_program,
                      predicate=is_persistable, scope=scope_,
                      extra_state=_checkpoint_rng_extra(scope_),
                      _manifest_extra=names)
            self._commit(no, stage)
        finally:
            self._release(no)

    def _write_arrays(self, no, stage, arrays, meta, extra_files):
        try:
            os.makedirs(stage, exist_ok=True)
            names = self._write_extra_files(stage, extra_files)
            _write_array_dir(stage, arrays, meta, manifest_extra=names)
            self._commit(no, stage)
        finally:
            self._release(no)

    def abandon_inflight(self):
        """Mark every in-flight (reserved, uncommitted) save abandoned:
        its commit is skipped and its staging directory removed, so a
        save the caller gave up on is never published. Returns the
        numbers."""
        with self._lock:
            nums = set(self._reserved)
            self._abandoned |= nums
        return nums

    def _commit(self, no, stage):
        with self._lock:
            abandoned = no in self._abandoned
            self._abandoned.discard(no)
        if abandoned:
            shutil.rmtree(stage, ignore_errors=True)
            return
        _maybe_fail("io.commit", path=self._path(no))
        os.replace(stage, self._path(no))
        _fsync_dir(self.dirname)
        self._prune(keep_at_least=no)

    def _prune(self, keep_at_least):
        if self.max_to_keep is not None:
            nums = self.checkpoint_numbers()
            drop = nums[:-self.max_to_keep] if self.max_to_keep else nums
            for n in drop:
                if n != keep_at_least:
                    shutil.rmtree(self._path(n), ignore_errors=True)
        self._gc_stale_temps()

    def _gc_stale_temps(self):
        """Remove ``.tmp`` staging entries that no in-flight save of this
        saver owns (a save killed mid-write leaves them behind); only the
        writing rank removes them."""
        if not os.path.isdir(self.dirname) or not _is_writer():
            return
        for entry in os.listdir(self.dirname):
            if not entry.endswith(".tmp"):
                continue
            if entry.startswith(self.prefix):
                try:
                    no = int(entry[len(self.prefix):-len(".tmp")])
                except ValueError:
                    no = None
                # checked at removal: a save reserves its number before
                # its staging dir exists
                with self._lock:
                    if no in self._reserved:
                        continue
            full = os.path.join(self.dirname, entry)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                try:
                    os.remove(full)
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# inference model
# ---------------------------------------------------------------------------

@_one_writer()
def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False, scope=None):
    """Prune ``main_program``'s eval clone to the ops that compute
    ``target_vars`` from ``feeded_var_names``; save it (the JSON program
    with its feed and fetch names and feed specs) and the persistables
    it reads. Returns the fetch var names."""
    if main_program is None:
        from .framework.core import default_main_program
        main_program = default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    target_names = [t.name if isinstance(t, Variable) else str(t)
                    for t in target_vars]
    pruned = main_program.clone(for_test=True)._prune(
        target_names, feeds=feeded_var_names)
    os.makedirs(dirname, exist_ok=True)
    gb = pruned.global_block()
    feed_specs = {}
    for n in feeded_var_names:
        var = gb.vars.get(n)
        shape = [int(d) for d in (getattr(var, "shape", None) or [])]
        feed_specs[n] = {"shape": shape,
                         "dtype": str(getattr(var, "dtype", "float32")
                                      or "float32")}
    model = {"program": pruned.to_dict(),
             "feed_var_names": list(feeded_var_names),
             "fetch_var_names": target_names,
             "feed_specs": feed_specs}
    rel_model = model_filename or _MODEL_FILE
    model_sha = _fsync_write(os.path.join(dirname, rel_model),
                             lambda f: f.write(json.dumps(model).encode()))
    if program_only:
        _write_manifest(dirname, [rel_model], {}, preserve_existing=True,
                        digests={rel_model: model_sha})
    else:
        save_vars(executor, dirname, main_program=pruned,
                  predicate=is_persistable, filename=params_filename,
                  scope=scope, _manifest_extra=[rel_model])
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """``(program, feed_target_names, fetch_targets)``; the program is
    verified (``framework.analysis.verify_program``), carries the saved
    feed specs as ``program._feed_specs``, and its persistables are
    loaded into the scope on the executor's device."""
    from .framework.analysis import verify_program
    rel_model = model_filename or _MODEL_FILE
    _verify_against_manifest(dirname, rel_model, _read_manifest(dirname))
    with open(os.path.join(dirname, rel_model)) as f:
        model = json.load(f)
    program = Program.from_dict(model["program"])
    program._is_test = True
    verify_program(program, fetch_names=model.get("fetch_var_names", ()),
                   feed_names=model.get("feed_var_names", ()))
    program._feed_specs = model.get("feed_specs")
    if any(is_persistable(v) for v in program.list_vars()):
        load_vars(executor, dirname, main_program=program,
                  predicate=is_persistable, filename=params_filename,
                  scope=scope)
    fetch_targets = [program.global_block().var(n)
                     for n in model["fetch_var_names"]]
    return program, model["feed_var_names"], fetch_targets


# ---------------------------------------------------------------------------
# single-file save/load (.pdparams, .pdopt, .pdmodel)
# ---------------------------------------------------------------------------

_PD_SUFFIXES = (".pdparams", ".pdparams.meta.json", ".pdopt",
                ".pdopt.meta.json", ".pdmodel")


def _split_persistables(program):
    params = [v for v in program.list_vars() if is_parameter(v)]
    others = [v for v in program.list_vars()
              if is_persistable(v) and not is_parameter(v)]
    return params, others


@_one_writer()
def save(program, model_path, scope=None):
    """Params to ``{model_path}.pdparams``, other persistables and the
    run seed to ``{model_path}.pdopt``, the program to
    ``{model_path}.pdmodel``."""
    scope = scope or global_scope()
    base_dir = os.path.dirname(os.path.abspath(model_path)) or "."
    os.makedirs(base_dir, exist_ok=True)
    base = os.path.basename(model_path)
    digests = {}

    def _dump(vars_, path, extra=None):
        arrays, meta = _collect_arrays(scope, vars_, extra)
        rel = os.path.basename(path)
        digests[rel] = _fsync_write(path, lambda f: np.savez(
            f, **{_escape(n): a for n, a in arrays.items()}))
        digests[rel + ".meta.json"] = _fsync_write(
            path + ".meta.json",
            lambda f: f.write(json.dumps(meta).encode()))

    params, others = _split_persistables(program)
    _dump(params, model_path + ".pdparams")
    _dump(others, model_path + ".pdopt", extra=_rng_extra(scope))
    digests[base + ".pdmodel"] = _fsync_write(
        model_path + ".pdmodel",
        lambda f: f.write(json.dumps(program.to_dict()).encode()))
    _write_manifest(base_dir, [base + sfx for sfx in _PD_SUFFIXES], {},
                    preserve_existing=True, digests=digests)


def load(program, model_path, executor=None, var_list=None, scope=None):
    """Restore ``{model_path}.pdparams``/``.pdopt`` into the scope for
    ``program``. Every file is checked against the manifest first."""
    scope = scope or global_scope()
    device = _device_of(executor)
    base_dir = os.path.dirname(os.path.abspath(model_path)) or "."
    base = os.path.basename(model_path)
    manifest = _read_manifest(base_dir)
    for sfx in _PD_SUFFIXES:
        if os.path.exists(os.path.join(base_dir, base + sfx)):
            _verify_against_manifest(base_dir, base + sfx, manifest)

    def _slurp(path, vars_):
        if not os.path.exists(path):
            if vars_:
                raise RuntimeError(
                    f"checkpoint file {path!r} does not exist but the "
                    f"program expects {len(vars_)} saved variables "
                    f"(e.g. {vars_[0].name!r})")
            return {}, {}
        meta = {"vars": {}, "extra": {}}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        staged, extras = {}, {}
        with np.load(path, allow_pickle=False) as z:
            for v in vars_:
                key = _escape(v.name)
                if key not in z.files:
                    raise RuntimeError(
                        f"no saved value for {v.name!r} in {path}")
                arr = z[key]
                tag = meta["vars"].get(v.name, {}).get("dtype") \
                    or str(arr.dtype)
                staged[v.name] = _restore(arr, tag, device, v.dtype)
            for name, info in meta.get("extra", {}).items():
                key = _escape(name)
                if key in z.files:
                    arr = z[key]
                    extras[name] = _restore(
                        arr, info.get("dtype") or str(arr.dtype), "cpu")
        return staged, extras

    params, others = _split_persistables(program)
    if var_list is not None:
        names = {v.name if isinstance(v, Variable) else str(v)
                 for v in var_list}
        params = [v for v in params if v.name in names]
        others = [v for v in others if v.name in names]
    staged, _ = _slurp(model_path + ".pdparams", params)
    staged_opt, extras = _slurp(model_path + ".pdopt", others)
    for name, t in {**staged, **staged_opt}.items():
        scope.set(name, t)
    _restore_rng(scope, extras)
