"""Builds and loads the port's CUDA kernels and its native host runtime.

All sources under ``tcnn_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The host runtime ``csrc/host/tcnn_host.cpp`` (outside the
``*.cu`` glob) is built by ``g++`` into a library of its own
(`host_library`). Each build happens at first use, never at import, into
``build/tcnn_tpu_torch/`` beside the package; a library's name carries a
hash of its sources and flags, so an edited source is rebuilt. An
``fcntl.flock`` serialises concurrent first uses and the finished library is
moved into place with ``os.replace``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "tcnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

HOST_SOURCE = CSRC / "host" / "tcnn_host.cpp"
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")

_lib = None
#: Seconds the last `library()` call spent building (0.0 when the library
#: was already built).
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> pathlib.Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtcnn_tpu_torch_{h.hexdigest()[:16]}.so"


def _build_once(path: pathlib.Path, build) -> float:
    """Run `build(tmp)`, which must leave the library at `path`, unless
    `path` exists; under the build directory's lock. Returns the seconds
    spent building (0.0 when the library was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return 0.0
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                build(pathlib.Path(tmp))
            return time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    path = library_path()
    build_seconds = _build_once(path, lambda tmp: _compile_and_link(_sources()[0], tmp, path))
    lib = ctypes.CDLL(str(path))
    lib.tcnn_error_string.argtypes = [ctypes.c_int]
    lib.tcnn_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def host_library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return BUILD_DIR / f"libtcnn_host_{h.hexdigest()[:16]}.so"


def host_library() -> pathlib.Path:
    """The path of the native host runtime's library, built with g++ first
    if needed; raises RuntimeError when it cannot be built."""
    path = host_library_path()

    def build(tmp: pathlib.Path) -> None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native host runtime cannot be built")
        lib = tmp / path.name
        _run_all([[cxx, *HOST_FLAGS, "-o", str(lib), str(HOST_SOURCE)]])
        os.replace(lib, path)

    _build_once(path, build)
    return path


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            name = pathlib.Path(cmd[0]).name
            raise RuntimeError(f"{name} failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


def _compile_and_link(sources, tmp: pathlib.Path, path: pathlib.Path) -> None:
    """One object per source, compiled in parallel, linked into a library
    in `tmp` and moved to `path`."""
    nvcc = _nvcc()
    objects = [tmp / f"{src.stem}.o" for src in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objects)])
    lib = tmp / path.name
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objects)]])
    os.replace(lib, path)


def function(name: str, argtypes):
    """Entry point `name` of the library, returning a cudaError_t as int."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().tcnn_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")
