"""The port's kernel loader (tcnn_tpu_torch/ops/cuda/_build.py) and its C
interface, checked on the CPU: the kernels themselves build and run only on
a CUDA machine (chip_smoke.py)."""

import ctypes
import re
import shutil

import pytest

from tcnn_tpu_torch.ops.cuda import (_build, adam_kernel, ext_kernel, grid_kernel, mlp_kernel,
                                     train_kernel)

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "unsigned": ctypes.c_uint32, "float": ctypes.c_float}


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
    assert sigs["tcnn_grid_bwd"] == grid_kernel._GRID_BWD_ARGS
    assert sigs["tcnn_mlp_bwd"] == mlp_kernel._MLP_BWD_ARGS
    assert sigs["tcnn_mlp_bwd_split"] == mlp_kernel._MLP_BWD_SPLIT_ARGS
    assert sigs["tcnn_fused_train"] == train_kernel._FUSED_TRAIN_ARGS
    assert sigs["tcnn_grid_bwd_ig"] == grid_kernel._GRID_BWD_IG_ARGS
    assert sigs["tcnn_grid_bwd_bwd"] == grid_kernel._GRID_BWD_BWD_ARGS
    assert sigs["tcnn_fused_ig"] == train_kernel._FUSED_IG_ARGS
    assert sigs["tcnn_ext_gather"] == ext_kernel._EXT_GATHER_ARGS
    assert sigs["tcnn_ext_scatter"] == ext_kernel._EXT_SCATTER_ARGS
    assert sigs["tcnn_ext_lookup"] == ext_kernel._EXT_LOOKUP_ARGS
    assert sigs["tcnn_ext_lookup_bwd"] == ext_kernel._EXT_LOOKUP_BWD_ARGS
    assert sigs["tcnn_adam_step"] == adam_kernel._ADAM_STEP_ARGS
    # the persistent grids, called as mlp_kernel.persistent_grid calls them
    assert sigs["tcnn_grid_bwd_grid"] == [ctypes.c_int] * 4
    assert sigs["tcnn_mlp_bwd_grid"] == [ctypes.c_int] * 9
    assert sigs["tcnn_mlp_bwd_split_grid"] == [ctypes.c_int] * 8
    assert sigs["tcnn_fused_train_grid"] == [ctypes.c_int] * 11
    assert sigs["tcnn_fused_ig_grid"] == [ctypes.c_int] * 11


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
