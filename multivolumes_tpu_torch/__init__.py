"""multivolumes_tpu_torch — the renderer on PyTorch and hand-written Hopper
kernels.

A port of `multivolumes_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
H100: the module tree mirrors the JAX package (`core/`, `scene/`,
`render/`, `ops/`), plain tensor code is PyTorch, and each Pallas kernel
on the ported path is a CUDA C++ kernel in `csrc/` (built for `sm_90a` at
first use, `ops/build.py`) with a plain PyTorch version beside it
(`ops/*.py`). The package keeps its own copy of the configuration
(`config.py`) and never imports `jax` or the JAX package.

Ported so far: the whole single-device system, TAA and the opaque mesh
included: the frame (`render/frame.py:render_frame`, `render_frames`),
the mesh pass (`render/mesh.py`), the engine with its setters and
`set_mesh` (`engine.py`) and the offline app (`python -m
multivolumes_tpu_torch.app`).
"""

from multivolumes_tpu_torch.config import RenderConfig, SharedConsts

__all__ = ["RenderConfig", "SharedConsts"]
