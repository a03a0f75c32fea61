"""Checkpoint and resume of the scene state.

Counterpart of `multivolumes_tpu/utils/checkpoint.py`: a checkpoint is a
flat npz of the `SceneState` fields, bf16 fields stored as f32 and named
in `__bf16_fields__`, so a run resumes exactly (the TAA history and the
frame counter are part of the state). `load_scene` also reads a
checkpoint that the JAX package wrote: its fields are those of the JAX
state, carried across by `scene.state.state_from_numpy` with the sweep
dtype its bf16 list gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multivolumes_tpu_torch.scene.state import SceneState, state_from_numpy

_FIELDS = [f.name for f in dataclasses.fields(SceneState)]


def save_scene(path: str, state: SceneState) -> None:
    arrays, bf16_fields = {}, []
    for name in _FIELDS:
        x = getattr(state, name)
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:  # no npz representation
                x = x.float()
                bf16_fields.append(name)
            x = x.cpu().numpy()
        arrays[name] = np.asarray(x)
    arrays["__bf16_fields__"] = np.asarray(bf16_fields, dtype="U64")
    np.savez_compressed(path, **arrays)


def load_scene(path: str, device="cuda") -> SceneState:
    """A checkpoint of either package -> the port's state on `device`."""
    with np.load(path) as data:
        arrays = {name: data[name] for name in data.files}
    bf16 = set(arrays.pop("__bf16_fields__", np.zeros(0, "U64")).tolist())
    if "volumes_oriented" in arrays:   # written by the JAX package
        return state_from_numpy(
            arrays, device=device,
            dtype=(torch.bfloat16 if "volumes_oriented" in bf16
                   else torch.float32))
    return SceneState(**{
        name: int(arrays[name]) if name == "frame_idx" else
        torch.from_numpy(arrays[name]).to(
            device=device,
            dtype=torch.bfloat16 if name in bf16 else None)
        for name in _FIELDS})
