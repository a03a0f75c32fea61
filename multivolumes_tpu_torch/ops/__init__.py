"""Hand-written Hopper kernels and their plain PyTorch versions.

Dispatch rule, shared by every kernel wrapper in this package:

* tensors on a CUDA device take the hand kernel (`csrc/*.cu`, built at
  first use by `ops.build`); tensors on the CPU take the plain version;
* `impl="kernel"` or `impl="plain"` forces one side. `impl="kernel"` on
  CPU tensors raises: a CUDA kernel has no CPU mode;
* there is no fallback: a kernel that fails to build or to launch raises,
  and nothing moves a tensor between devices.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel,
and nowhere else, so a run can show which kernels its path went through.
"""

from __future__ import annotations

import torch

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"sweep": 0, "sweep_prologue": 0, "composite": 0,
            "composite_depth": 0, "composite_band": 0,
            "composite_depth_band": 0,
            "light_self_scan": 0, "light_self_scan_sm": 0,
            "light_advect_mul": 0, "light_prologue": 0,
            "light_occlusion": 0, "light_epilogue": 0, "taa": 0,
            "taa_band": 0,
            "raster_bin_eval": 0, "mesh_shade": 0, "raster": 0,
            "lod_partition": 0, "lod_store": 0}

IMPLS = (None, "kernel", "plain")


def use_kernel(impl: str | None, x: torch.Tensor) -> bool:
    """True when the wrapper must launch its hand kernel on `x`'s device."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain":
        return False
    if impl == "kernel" and not x.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; this one is on "
                         f"{x.device}")
    return x.is_cuda


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda(t: torch.Tensor, name: str, dtype=None) -> None:
    """Validate an operand before its pointer reaches a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
