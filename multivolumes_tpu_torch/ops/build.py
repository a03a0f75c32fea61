"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper
(`sm_90a`), all of them at once, and the objects are linked into one
shared library with a plain C interface, at first use, under
`build/torch_ext/` at the repository root (listed in `.gitignore`), and
loaded with `ctypes`. The library's file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale build is
never loaded. Nothing is fetched or prebuilt.

Why not `torch.utils.cpp_extension.load`: a source that includes
PyTorch's headers takes minutes to compile, against seconds for this
plain C interface, and every fresh machine builds anew.

`--use_fast_math` stays off on purpose: it swaps `exp2f`/`log2f`/
`rsqrtf` for approximations, and the opacity term
`exp2(f * log2(1 - 0.8 rho))` would drift past the parity tolerances.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES = {
    "mv_sweep_march": [_P] * 15 + [_I] * 6 + [_F, _P],
    "mv_sweep_info": [_I, _I, _I, _I, _I, _P],
    "mv_sweep_prologue": [_P] * 11 + [_I] * 14 + [_F] * 3 + [_P],
    "mv_tile_composite": [_P] * 9 + [_I] * 12 + [_P],
    "mv_tile_composite_info": [_I, _I, _P],
    "mv_light_self_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "mv_light_self_scan_sm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _P],
    "mv_light_advect_mul": [_P, _P, _P, _P, _P, _I, _I, _P],
    "mv_light_scan_floor": [_I, _I, _I, _I, _P],
    "mv_light_scan_info": [_I, _I, _I, _P],
    "mv_light_prologue": [_P] * 12 + [_I] * 6 + [_F] * 5 + [_P],
    "mv_light_occlusion": [_P] * 5 + [_I] * 3 + [_P],
    "mv_light_epilogue": [_P] * 14 + [_I] * 5 + [_P],
    "mv_taa_resolve": [_P, _P, _P, _P, _P, _I, _I, _P],
    "mv_taa_resolve_band": [_P, _P, _P, _P, _I, _I, _P],
    "mv_raster_bin_eval": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mv_mesh_shade": [_P] * 19 + [_I] * 18 + [_P],
    "mv_raster_setup": [_P] * 7 + [_I] * 5 + [_P],
    "mv_raster_draw": [_P] * 5 + [_I, _P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    "mv_lod_partition": [_P] * 23 + [_I] * 10 + [_P],
    "mv_lod_store": [_P] * 5 + [_I] * 5 + [_P],
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _check(cmd, returncode: int, stdout: str, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}"
                           f"\n{stdout}\n{stderr}")


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    digest = _digest()
    out = BUILD_DIR / f"libmv_kernels_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest}.tmp{os.getpid()}"
        nvcc = nvcc_path()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        done = [(cmd, proc, *proc.communicate()) for cmd, _obj, proc in jobs]
        for cmd, proc, stdout, stderr in done:
            _check(cmd, proc.returncode, stdout, stderr)
        tmp = BUILD_DIR / f"libmv_kernels_{tag}.so"
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *[str(obj) for _cmd, obj, _proc in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, proc.returncode, proc.stdout, proc.stderr)
        for _cmd, obj, _proc in jobs:
            obj.unlink()
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args, device) -> None:
    """Call C entry point `name` with `args` and, as its last argument,
    the current stream of `device`, with `device` selected (a launch goes
    to the thread's current device, whatever device its pointers are on);
    raise if the launch was refused."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        lib.mv_error_string.restype = ctypes.c_char_p
        lib.mv_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} "
                           f"({lib.mv_error_string(err).decode()})")
