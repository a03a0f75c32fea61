"""The benchmark's inputs, made from `--seed`: densities, cameras, mesh.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* `densities`: the density of the demo's procedural stand-in for its DDS
  sources (`scene/volume.py:init_grid_variant` of the port: the sphere
  falloff modulated by three low-frequency cosine lobes), made on the
  device, its lobes drawn from the seed. They are loaded as R32F grids
  (`MultiRayCaster.load_volume_data`, the reference's `-volume` path).
* `orbit`: the demo's auto-animation (`core/camera.py:orbit_camera`,
  `MultiVolumes.cpp:328-337`): eye = (sin(t/2) r, h, cos(t/2) r) looking
  at the focus, fov pi/4, z in [1, 1000] (`XMMatrixLookAtLH`,
  `XMMatrixPerspectiveFovLH`), t advancing a fixed step a frame from a
  starting phase drawn from the seed.
* `write_torus`: the closed test torus that stands in for the demo's
  `bunny.obj` (`scene/io_obj.py:write_torus_obj`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

FOV_Y = math.pi / 4.0
Z_NEAR, Z_FAR = 1.0, 1000.0


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of the seed."""
    return np.random.default_rng(
        [seed % 2 ** 64, int.from_bytes(stream.encode()[:8], "little")])


def densities(seed: int, count: int, grid: int, device) -> list[np.ndarray]:
    """`count` (grid, grid, grid) R32F density fields, made on `device`
    from the seed -> host arrays (what `load_volume_data` takes)."""
    g = rng(seed, "density")
    ts = (torch.arange(grid, dtype=torch.float32, device=device) + 0.5) \
        / grid * 2.0 - 1.0
    z, y, x = torch.meshgrid(ts, ts, ts, indexing="ij")
    base = torch.clamp(1.0 - (x * x + y * y + z * z), min=0.0) ** 2
    out = []
    for _ in range(count):
        mod = torch.ones_like(base)
        for _lobe in range(3):
            k = g.uniform(1.5, 4.0, size=3)
            ph = g.uniform(0.0, 2.0 * np.pi, size=3)
            mod *= 0.5 + 0.5 * torch.cos(k[0] * np.pi * x + ph[0]) \
                * torch.cos(k[1] * np.pi * y + ph[1]) \
                * torch.cos(k[2] * np.pi * z + ph[2])
        a = torch.clamp(base * (0.35 + 1.3 * mod) * 2.0, 0.0, 1.0)
        out.append(a.cpu().numpy())
    return out


def orbit_phase(seed: int) -> float:
    """The orbit's starting time (s): anywhere on the circle."""
    return float(rng(seed, "orbit").uniform(0.0, 4.0 * np.pi))


def look_at_lh(eye, focus, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Row-vector view matrix (`XMMatrixLookAtLH`), f32."""
    eye, focus, up = (np.asarray(v, np.float32) for v in (eye, focus, up))
    z = focus - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
    m[3, :3] = (-(x @ eye), -(y @ eye), -(z @ eye))
    return m


def perspective_fov_lh(aspect: float) -> np.ndarray:
    """`XMMatrixPerspectiveFovLH` (clip z in [0, 1]), f32."""
    h = 1.0 / math.tan(FOV_Y * 0.5)
    q = Z_FAR / (Z_FAR - Z_NEAR)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 2], m[2, 3] = h / aspect, h, q, 1.0
    m[3, 2] = -q * Z_NEAR
    return m


def orbit(camera: dict, phase: float, frame: int, aspect: float):
    """Frame `frame` of the orbit of a traffic file's `camera` ->
    (eye (3,), view (4, 4), proj (4, 4)), host f32."""
    if camera["path"] != "orbit":
        raise ValueError(f"unknown camera path {camera['path']!r}")
    t = 0.5 * (phase + frame * float(camera["time_step"]))
    r = float(camera["radius"])
    eye = np.array([math.sin(t) * r, float(camera["height"]),
                    math.cos(t) * r], np.float32)
    return eye, look_at_lh(eye, camera["focus"]), perspective_fov_lh(aspect)


def write_torus(path, n_tris: int, major: float = 3.0, minor: float = 1.2,
                y0: float = 2.0) -> str:
    """A closed torus of about `n_tris` triangles as an OBJ, lying flat
    (axis y) at height y0, faces counter-clockwise seen from outside."""
    nv = max(3, int(round(np.sqrt(n_tris / 4.0))))
    nu = max(3, int(round(n_tris / (2.0 * nv))))
    th = np.arange(nu) * (2.0 * np.pi / nu)
    ph = np.arange(nv) * (2.0 * np.pi / nv)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = major + minor * np.cos(p)
    verts = np.stack([ring * np.cos(t), y0 + minor * np.sin(p),
                      ring * np.sin(t)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    v0, v1, v2 = verts[faces[0]]
    centre = np.array([major * np.cos(th[0]), y0, major * np.sin(th[0])])
    if np.dot(np.cross(v1 - v0, v2 - v0), v0 - centre) < 0:
        faces = faces[:, [0, 2, 1]]
    with open(path, "w") as f:
        f.write(f"# torus, {len(faces)} triangles\n")
        f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n"
                        for x, y, z in verts))
        f.write("".join(f"f {x + 1} {y + 1} {z + 1}\n"
                        for x, y, z in faces))
    return str(path)
