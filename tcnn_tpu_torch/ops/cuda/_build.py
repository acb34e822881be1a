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

Every C entry point returns a cudaError_t as int and is bound once, when
the library loads, from its declaration (`signatures`); a kernel's ends in
(int device, void* stream), which `launch` passes.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

import torch

from ...utils import profiling

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "tcnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

HOST_SOURCE = CSRC / "host" / "tcnn_host.cpp"
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")

#: The ctypes type of each C parameter type the entry points take.
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "unsigned": ctypes.c_uint32, "float": ctypes.c_float}

#: Each kernel's entry point -> its label, counted as "launches.<label>"
#: once a launch (K5's split plan is one launch of K5).
KERNELS = {
    "tcnn_grid_fwd": "K1", "tcnn_mlp_fwd": "K2", "tcnn_fused_infer": "K3",
    "tcnn_grid_bwd": "K4", "tcnn_mlp_bwd": "K5", "tcnn_mlp_bwd_split": "K5",
    "tcnn_fused_train": "K6", "tcnn_grid_bwd_ig": "K7", "tcnn_grid_bwd_bwd": "K8",
    "tcnn_fused_ig": "K9", "tcnn_ext_gather": "K10", "tcnn_ext_scatter": "K11",
    "tcnn_ext_lookup": "K12", "tcnn_ext_lookup_bwd": "K13", "tcnn_adam_step": "K14",
}
_COUNTERS = {name: f"launches.{label}" for name, label in KERNELS.items()}

_lib = None
#: Entry point name -> its ctypes function, bound when the library loads.
_entries: dict = {}
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
    _entries.update(_bind(lib))
    _lib = lib
    return lib


def signatures() -> dict:
    """name -> [ctypes type] of every ``extern "C" int`` entry point in
    ``csrc/*.cu``, read from its definition; raises for a parameter type
    outside C_TYPES, naming the entry point."""
    sigs = {}
    for path in _sources()[0]:
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', path.read_text()):
            types = []
            for p in params.split(","):
                ctype = " ".join(p.split()[:-1]).replace(" *", "*")
                if ctype not in C_TYPES:
                    raise ValueError(f"{name}: parameter {p.strip()!r} has no ctypes type")
                types.append(C_TYPES[ctype])
            sigs[name] = types
    return sigs


def _bind(lib) -> dict:
    """Each entry point of `lib` with its argtypes from its declaration and
    an int result; `tcnn_error_string` (the one that returns a string) set
    on `lib` itself."""
    lib.tcnn_error_string.argtypes = [ctypes.c_int]
    lib.tcnn_error_string.restype = ctypes.c_char_p
    entries = {}
    for name, argtypes in signatures().items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


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


def entry(name: str):
    """Entry point `name` of the library, bound once (the library loaded
    first if needed)."""
    if not _entries:
        library()
    return _entries[name]


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point `name` with `args`, then `device`'s index
    and current stream; raise on the CUDA error it returns; count the
    launch under its kernel's label."""
    stream = torch.cuda.current_stream(device).cuda_stream
    check(entry(name)(*args, device.index, stream), name)
    profiling.count(_COUNTERS[name])


def launch_counts() -> dict:
    """Each kernel's launches in this process since the counters were last
    reset, by label (K1-K14)."""
    counted = profiling.counts("launches.")
    return {label: counted.get(f"launches.{label}", 0) for label in dict.fromkeys(KERNELS.values())}


def persistent_grid(name: str, args, device: torch.device) -> int:
    """The persistent grid of K4-K9 (entry point `name`, e.g.
    `tcnn_fused_train_grid`), as the C side chooses it from the kernel's
    occupancy on `device`: the blocks resident at once, never more than the
    tiles. Asked once per (name, args, card) of the last 1024 (ragged
    batches each take one); an error raises and is not kept."""
    return _persistent_grid(name, tuple(args), device.index)


@functools.lru_cache(maxsize=1024)
def _persistent_grid(name: str, args: tuple, index: int) -> int:
    grid = entry(name)(*args, index)
    if grid < 0:
        check(-grid, name)
    if grid == 0:
        raise ValueError(f"{name}{args}: no block fits the card's shared memory")
    return grid


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().tcnn_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")
