"""The reference frames of a run's checked samples."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mvbench.reference.config import RenderConfig
from mvbench.reference.core.camera import Camera
from mvbench.reference.engine import build_scene, light_refresh, raster_preset
from mvbench.reference.precision import EXACT
from mvbench.reference.render.frame import render_frame


def camera(pose, device) -> Camera:
    eye, view, proj = (torch.as_tensor(np.asarray(x, np.float32),
                                       device=device) for x in pose)
    return Camera(eye=eye, view=view, proj=proj)


def render_samples(render: dict, densities, mesh_path, show_mesh: bool,
                   start, replayed, window, pose, device, prec=EXACT):
    """Reference frames of the `start` sample (from the reference's own
    set-up state), of the `replayed` sample (every frame from the start
    to it rendered in turn, from the reference's own state), and of the
    `window` samples (each from the TAA history its sample started
    from), in that order -> [FrameOutput].

    `render`: the RenderConfig fields of the configuration; `densities`,
    `mesh_path`, `show_mesh`: the run's inputs; `pose(i)` -> frame i's
    (eye, view, proj) on the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = build_scene(RenderConfig(**render), densities, mesh_path,
                        show_mesh, device, prec)
    cfg = scene.config
    last = max(s.index for s in [start, replayed, *window] if s is not None)
    presets, preset = [], cfg.raster_preset
    for i in range(last + 1):
        preset = raster_preset(cfg, scene.mesh_aabb, pose(i)[0], preset)
        presets.append(preset)

    def frame(state, i):
        return render_frame(dataclasses.replace(state, frame_idx=i),
                            camera(pose(i), device),
                            cfg.with_(raster_preset=presets[i]), prec=prec)

    out = []
    state = scene.state
    if start is not None:
        ref = frame(state, start.index)
        out.append(ref)
        if replayed is not None:
            for i in range(start.index + 1, replayed.index + 1):
                ref = frame(ref.state, i)
            out.append(ref)
            del ref
    if window and cfg.show_mesh != (mesh_path is not None):
        # the shown frames refresh the light cohort without the mesh's
        # shadow that set-up drew them with; after two rounds of the
        # cohort every map and footprint is the unshadowed refresh's
        state = light_refresh(state, cfg, shadow=False, prec=prec)
    for s in window:
        prev = camera(pose(s.index - 1), device)
        state_k = dataclasses.replace(
            state, taa_history=s.prev_history.to(device=device,
                                                 dtype=torch.float32),
            mesh_prev_wvp=state.mesh_world @ prev.view_proj)
        ref = frame(state_k, s.index)
        state = dataclasses.replace(ref.state, taa_history=state.taa_history)
        out.append(ref)
    return out
