"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with nvcc for Hopper (``sm_90a``) into ``_build/lib<name>.so``
inside this package, rebuilt when the source is newer, and loaded with
ctypes.  Every C entry point launches on the stream it is given, does not
synchronise, and returns ``cudaGetLastError()``; ``check`` turns a nonzero
code into an exception.  Nothing here runs at import time: a machine
without nvcc or a card imports this module and never calls it.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import os
import shutil
import subprocess
import tempfile
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
# every library's launch entry points, one per value type, and their
# argument codes: p void* (device pointer, host pointer or stream),
# n long long, i int.  Each returns an int CUDA error code.
_EXPORTS = {
    "dia_spmv": "pppnnpip",
    "banded_spmv": "ppppnnninnp",
}
KERNELS = tuple(_EXPORTS)
_CTYPES = {"p": ctypes.c_void_p, "n": ctypes.c_longlong, "i": ctypes.c_int}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str, src: str | None = None, tag: str = "",
          flags=()) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path and nvcc's standard error ("" when the
    library was up to date).  A ``tag`` builds ``src`` (another source with
    the C interface of ``<name>``, by default ``csrc/<name>.cu``) with the
    extra nvcc ``flags`` into ``lib<name>_<tag>.so`` beside the others, for
    tools that time a variant of a kernel."""
    src = src or os.path.join(CSRC, name + ".cu")
    out = os.path.join(BUILD_DIR, f"lib{name}{'_' + tag if tag else ''}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name and rename, so a concurrent reader never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stderr


def build_all() -> float:
    """Build every kernel library, one nvcc for each source, all started
    together, and load them; returns the seconds it took."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build, KERNELS))  # re-raises a failed build
    for name in KERNELS:
        load(name)
    return time.perf_counter() - t0


def load(name: str, src: str | None = None, tag: str = "",
         flags=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), or
    of a tagged build (see ``build``).  It exports ``<name>_f32`` and
    ``<name>_f64`` with the argument codes of ``_EXPORTS``, and
    ``<name>_error_string``, which names a code."""
    key = f"{name}_{tag}" if tag else name
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(build(name, src, tag, flags)[0])
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.restype = ctypes.c_int
            fn.argtypes = [_CTYPES[c] for c in _EXPORTS[name]]
        err = getattr(lib, name + "_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[key] = lib
    return lib


def launch(name: str, dtype, *args, lib: ctypes.CDLL | None = None):
    """Call the ``dtype`` (torch.float32 or torch.float64) entry point of
    kernel ``name`` (in ``lib``, a tagged build from ``load``, if given)
    and raise if it returns a CUDA error."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    lib = lib or load(name)
    rc = getattr(lib, name + suffix)(*args)
    if rc != 0:
        msg = getattr(lib, name + "_error_string")(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
