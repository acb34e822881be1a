"""The port's kernel loader (tcnn_tpu_torch/ops/cuda/_build.py) and its C
interface, checked on the CPU: the kernels themselves build and run only on
a CUDA machine (chip_smoke.py)."""

import ctypes
import shutil
from types import SimpleNamespace

import pytest
import torch

from tcnn_tpu_torch.ops.cuda import _build
from tcnn_tpu_torch.utils import profiling


def test_argtypes_match_the_c_entry_points():
    """`_build.signatures` reads every `extern "C" int` entry point in
    csrc/, each parameter's ctypes type from its C type; every kernel of the
    label table is one of them and ends in (int device, void* stream); the
    persistent grids take the arities their wrappers pass, and the device."""
    sigs = _build.signatures()
    declared = sum(p.read_text().count('extern "C" int ') for p in _build.CSRC.glob("*.cu"))
    assert len(sigs) == declared == 23
    for types in sigs.values():
        assert set(types) <= set(_build.C_TYPES.values())
    assert sigs["tcnn_fused_train"][-3:] == [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    assert sigs["tcnn_grid_fwd"][11:16] == [ctypes.c_uint32] * 4 + [ctypes.c_int]  # c_hash()
    assert sigs["tcnn_mlp_tile"] == [ctypes.c_int] * 5
    assert set(_build.KERNELS) <= set(sigs)
    for name in _build.KERNELS:
        assert sigs[name][-2:] == [ctypes.c_int, ctypes.c_void_p], name
    assert sorted(set(_build.KERNELS.values()), key=lambda k: int(k[1:])) == [
        f"K{i}" for i in range(1, 15)]
    assert sigs["tcnn_grid_bwd_grid"] == [ctypes.c_int] * 4
    assert sigs["tcnn_mlp_bwd_grid"] == [ctypes.c_int] * 9
    assert sigs["tcnn_mlp_bwd_split_grid"] == [ctypes.c_int] * 8
    assert sigs["tcnn_fused_train_grid"] == [ctypes.c_int] * 11
    assert sigs["tcnn_fused_ig_grid"] == [ctypes.c_int] * 11


def test_an_unknown_c_parameter_type_raises_naming_its_entry_point(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "odd.cu").write_text('extern "C" int tcnn_odd(double x, int device) {\n}\n')
    monkeypatch.setattr(_build, "CSRC", src)
    with pytest.raises(ValueError, match="tcnn_odd"):
        _build.signatures()


class _StubLibrary:
    """A stand-in for the kernel library: records each attribute read and
    each call; an entry point returns the next of its queued codes (0 when
    none is queued)."""

    def __init__(self):
        self.reads, self.calls, self.codes = [], [], {}

    def __getattr__(self, name):
        if name.startswith("tcnn_"):
            self.reads.append(name)

            def fn(*args):
                self.calls.append((name, args))
                queued = self.codes.get(name)
                return queued.pop(0) if queued else 0

            return fn
        raise AttributeError(name)


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLibrary()
    lib.tcnn_error_string = lambda rc: b"stub error"
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "_entries", _build._bind(lib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0xC0DE))
    _build._persistent_grid.cache_clear()
    yield lib
    _build._persistent_grid.cache_clear()


def test_launch_binds_once_appends_device_and_stream_checks_and_counts(stub):
    """Every entry point is bound when the library loads, with argtypes
    from its declaration, and never again; `launch` passes the device index
    and the current stream last, raises with the entry point's name on a
    non-zero code, and counts each launch under the label table's kernel
    (both K5 plans as K5)."""
    sigs = _build.signatures()
    assert sorted(stub.reads) == sorted(sigs)
    assert all(_build.entry(n).argtypes == sigs[n] and _build.entry(n).restype is ctypes.c_int
               for n in sigs)
    dev = torch.device("cuda", 3)
    before = profiling.counts("launches.")
    for _ in range(3):
        _build.launch("tcnn_ext_gather", dev, 1, 2, 3, 4, 5, 6)
    _build.launch("tcnn_mlp_bwd", dev, 7)
    _build.launch("tcnn_mlp_bwd_split", dev, 8)
    assert sorted(stub.reads) == sorted(sigs)  # no binding at launch
    assert stub.calls == [("tcnn_ext_gather", (1, 2, 3, 4, 5, 6, 3, 0xC0DE))] * 3 + [
        ("tcnn_mlp_bwd", (7, 3, 0xC0DE)), ("tcnn_mlp_bwd_split", (8, 3, 0xC0DE))]
    after = profiling.counts("launches.")
    assert after["launches.K10"] == before.get("launches.K10", 0) + 3
    assert after["launches.K5"] == before.get("launches.K5", 0) + 2
    assert _build.launch_counts()["K10"] == after["launches.K10"]
    stub.codes["tcnn_adam_step"] = [700]
    with pytest.raises(RuntimeError, match=r"tcnn_adam_step failed: CUDA error 700 \(stub error\)"):
        _build.launch("tcnn_adam_step", dev)
    assert profiling.counts("launches.K14").get("launches.K14", 0) == before.get(
        "launches.K14", 0)  # a failed launch is not counted


def test_persistent_grid_asks_once_per_key_and_keeps_no_error(stub):
    """The occupancy query runs once per (entry point, args, card); a
    negative code raises as a CUDA error and a 0 as no block fitting, and
    neither is kept: the next call asks again."""
    dev, other = torch.device("cuda", 0), torch.device("cuda", 1)
    stub.codes["tcnn_grid_bwd_grid"] = [96, 132, -2, 0, 64]
    assert _build.persistent_grid("tcnn_grid_bwd_grid", (1024, 2, 0), dev) == 96
    assert _build.persistent_grid("tcnn_grid_bwd_grid", [1024, 2, 0], dev) == 96
    assert _build.persistent_grid("tcnn_grid_bwd_grid", (1024, 2, 0), other) == 132
    with pytest.raises(RuntimeError, match="tcnn_grid_bwd_grid failed: CUDA error 2"):
        _build.persistent_grid("tcnn_grid_bwd_grid", (7, 2, 0), dev)
    with pytest.raises(ValueError, match="no block fits"):
        _build.persistent_grid("tcnn_grid_bwd_grid", (7, 2, 0), dev)
    assert _build.persistent_grid("tcnn_grid_bwd_grid", (7, 2, 0), dev) == 64
    assert _build.persistent_grid("tcnn_grid_bwd_grid", (7, 2, 0), dev) == 64
    assert stub.calls == [("tcnn_grid_bwd_grid", (1024, 2, 0, 0)),
                          ("tcnn_grid_bwd_grid", (1024, 2, 0, 1))] + [
        ("tcnn_grid_bwd_grid", (7, 2, 0, 0))] * 3


def test_library_path_tracks_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    edited = src / "grid_fwd.cu"
    edited.write_text(edited.read_text() + "\n// edited\n")
    second = _build.library_path()
    assert second != first
    header = src / "mlp_frag.cuh"  # a header every MLP kernel includes
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != second


def test_build_compiles_each_source_in_parallel_then_links(tmp_path, monkeypatch):
    """One nvcc per source, all started before any is waited on, then one
    link of the objects (a stand-in `nvcc` records its calls)."""
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; done\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    sources = sorted(_build.CSRC.glob("*.cu"))
    out = tmp_path / "lib.so"
    _build._compile_and_link(sources, tmp_path, out)
    calls = log.read_text().splitlines()
    assert len(calls) == len(sources) + 1 and len(sources) == 21
    assert all(" -c " in c for c in calls[:-1]) and " -shared " in calls[-1]
    assert sorted(c.split()[-1] for c in calls[:-1]) == sorted(map(str, sources))
    assert out.exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
