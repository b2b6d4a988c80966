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

``save_checkpoint``/``load_checkpoint`` and ``CheckpointSaver`` are not
ported and raise.
"""
import hashlib
import json
import os

import numpy as np
import torch

from .device import resolve_device
from .framework.core import Parameter, Program, Variable
from .framework.dtype import torch_dtype
from .framework.executor import RNG_STATE_NAME, global_scope
from .framework.lowering import splitmix64
from .resilience import CheckpointCorruptError

_META_FILE = "__meta__.json"
_MODEL_FILE = "__model__"
_MANIFEST_FILE = "_manifest.json"
# the JAX package's name for its PRNG key in the scope and the meta extras
JAX_RNG_KEY_NAME = "@RNG_KEY@"
_MASK64 = (1 << 64) - 1

__all__ = ["CheckpointCorruptError", "is_parameter", "is_persistable", "load", "load_inference_model",
           "load_params", "load_persistables", "load_vars", "save",
           "save_inference_model", "save_params", "save_persistables",
           "save_vars", "verify_checkpoint"]


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
    rename. Returns the content sha256 (None if ``write_fn`` seeked)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        w = _Sha256Writer(f)
        write_fn(w)
        f.flush()
        os.fsync(f.fileno())
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


def _storable(value):
    """(numpy array to store, dtype tag) of a scope value. bfloat16 has
    no numpy dtype: it is stored as its uint16 view under the tag
    ``bfloat16``, as the JAX package stores it."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(value)
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


def _collect_arrays(scope, var_list, extra_state=None):
    """Scope values of ``var_list`` (+ named extra state) as
    ``({name: storable array}, meta)``."""
    arrays, meta = {}, {"vars": {}, "extra": {}}
    for var in var_list:
        val = scope.find_var(var.name)
        if val is None:
            raise RuntimeError(
                f"variable {var.name!r} has no value in the scope: run the "
                f"startup program (and any training) before saving")
        arr, tag = _storable(val)
        arrays[var.name] = arr
        meta["vars"][var.name] = {"dtype": tag, "shape": list(arr.shape)}
    for name, val in (extra_state or {}).items():
        arr, tag = _storable(val)
        arrays[name] = arr
        meta["extra"][name] = {"dtype": tag}
    return arrays, meta


def _rng_extra(scope):
    seed = scope.find_var(RNG_STATE_NAME)
    return {} if seed is None \
        else {RNG_STATE_NAME: np.array([int(seed)], np.int64)}


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
    meta = _merged_meta(dirname, meta)
    if filename is None:
        digests = {}
        for name, arr in arrays.items():
            rel = _escape(name) + ".npy"
            digests[rel] = _fsync_write(
                os.path.join(dirname, rel),
                lambda f, _a=arr: np.save(f, _a, allow_pickle=False))
    else:
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

def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_vars(executor, dirname, main_program=main_program,
              predicate=is_parameter, filename=filename, scope=scope)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program=main_program,
              predicate=is_parameter, filename=filename, scope=scope)


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


def save_checkpoint(*args, **kwargs):
    raise NotImplementedError("paddle_tpu_torch: save_checkpoint (the "
                              "train/* resume path) is not ported")


def load_checkpoint(*args, **kwargs):
    raise NotImplementedError("paddle_tpu_torch: load_checkpoint (the "
                              "train/* resume path) is not ported")


class CheckpointSaver:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("paddle_tpu_torch: CheckpointSaver is "
                                  "not ported")


# ---------------------------------------------------------------------------
# inference model
# ---------------------------------------------------------------------------

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
