"""Builds the hand-written CUDA kernels on first use and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/paddle_tpu_torch/lib<name>.so``
at the root of the checkout, and loaded with ``ctypes``. A library is
rebuilt when its source, or any shared header ``csrc/*.cuh``, is newer
than it. ``-Xptxas -v`` makes the compiler report each kernel's
registers, shared memory and spills in the build output. Pointers travel as
``c_void_p``; every launch function returns a ``cudaError_t`` that
:func:`check` turns into an exception.

Nothing here runs at import: the CPU test suite imports every module
of the port, and this machine may have no ``nvcc``.
"""
import ctypes
import glob
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "paddle_tpu_torch")
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of paddle_tpu_torch are built on first use")


def _paths(name):
    return (os.path.join(_CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name):
    """True when the library is missing or older than its source or any
    shared header under ``csrc/``."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src, *glob.glob(os.path.join(_CSRC, "*.cuh"))]
    return os.path.getmtime(lib) < max(map(os.path.getmtime, deps))


def _start(name):
    """Start one nvcc process writing a private temporary file; returns
    (process, tmp path, final path)."""
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name, proc, tmp, lib):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)          # atomic: a reader never sees half a file
    return out


def build_all(names=SOURCES):
    """Build every stale kernel library, one ``nvcc`` per source, all
    started together. Returns {name: compiler output} for the ones
    built."""
    with _lock:
        started = {n: _start(n) for n in names if _stale(n)}
        return {n: _finish(n, *p) for n, p in started.items()}


def load(name):
    """The ``ctypes.CDLL`` of kernel ``name``, building it if stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            so = ctypes.CDLL(_paths(name)[1])
            so.pt_cuda_error_string.argtypes = [ctypes.c_int]
            so.pt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = so
        return _libs[name]


def check(lib, err, what):
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.pt_cuda_error_string(int(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t):
    """A tensor's device address as a ``c_void_p`` (None for None)."""
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def stream_of(t):
    """PyTorch's current stream on ``t``'s device, as a ``c_void_p``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
