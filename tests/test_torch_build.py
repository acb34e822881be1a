"""The port's kernel loader (tcnn_tpu_torch/ops/cuda/_build.py) and its C
interface, checked on the CPU: the kernels themselves build and run only on
a CUDA machine (chip_smoke.py)."""

import ctypes
import re
import shutil

import pytest

from tcnn_tpu_torch.ops.cuda import _build, grid_kernel, mlp_kernel, train_kernel

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "unsigned": ctypes.c_uint32}


def _c_signatures():
    """name -> [ctypes type] of every extern "C" entry point in csrc/."""
    sigs = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', path.read_text()):
            types = []
            for p in params.split(","):
                ctype = " ".join(p.split()[:-1]).replace(" *", "*")
                types.append(_C_TYPES[ctype])
            sigs[name] = types
    return sigs


def test_argtypes_match_the_c_entry_points():
    sigs = _c_signatures()
    assert sigs["tcnn_grid_fwd"] == grid_kernel._GRID_FWD_ARGS
    assert sigs["tcnn_mlp_fwd"] == mlp_kernel._MLP_FWD_ARGS
    assert sigs["tcnn_fused_infer"] == train_kernel._FUSED_INFER_ARGS
    assert sigs["tcnn_mlp_tile"] == [ctypes.c_int] * 5


def test_library_path_tracks_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    edited = src / "grid_fwd.cu"
    edited.write_text(edited.read_text() + "\n// edited\n")
    assert _build.library_path() != first


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
