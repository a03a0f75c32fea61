"""multivolumes_tpu_torch — the renderer on PyTorch and hand-written Hopper
kernels.

A port of `multivolumes_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
H100: the module tree mirrors the JAX package (`core/`, `scene/`,
`render/`, `ops/`), plain tensor code is PyTorch, and each Pallas kernel
on the ported path is a CUDA C++ kernel in `csrc/` (built for `sm_90a` at
first use, `ops/build.py`) with a plain PyTorch version beside it
(`ops/*.py`). The configuration is shared with the JAX package, whose
`config` module imports no JAX. This package never imports `jax`.

Ported so far: the whole system without a mesh, TAA included: the frame
(`render/frame.py:render_frame`, `render_frames`), the engine with its
setters (`engine.py`) and the offline app (`python -m
multivolumes_tpu_torch.app`).
"""

from multivolumes_tpu.config import RenderConfig, SharedConsts

__all__ = ["RenderConfig", "SharedConsts"]
