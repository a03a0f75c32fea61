"""Wavefront OBJ import.

Behavioral port of `XUSG::ObjLoader` (`XUSG/Optional/XUSGObjLoader.cpp`):
two-pass parse (count, then fill), per-vertex normals from face normals
when the file has none (`recomputeNormals`, XUSGObjLoader.cpp:337-385 —
*unit* face normals accumulated, then renormalized), split-vertex
assignment of file normals when present (`computePerVertexNormals`,
XUSGObjLoader.cpp:300-335), AABB computation. Used for the opaque-mesh
subsystem (`ObjectRenderer::Init`, `Content/ObjectRenderer.cpp:68-77`).

A copy of `multivolumes_tpu/scene/io_obj.py` (numpy); the JAX package's
C++ fast path (`native.load_obj_native`) is a host-side speed-up and is
not part of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Mesh(NamedTuple):
    vertices: np.ndarray  # (V, 6) position + normal, float32
    indices: np.ndarray   # (T, 3) int32
    aabb_min: np.ndarray  # (3,)
    aabb_max: np.ndarray  # (3,)

    @property
    def scene_size(self) -> float:
        """max extent — `ObjectRenderer.cpp:76` uses this * posScale.w."""
        return float(np.max(self.aabb_max - self.aabb_min))


def load_obj(path: str, for_dx: bool = True) -> Mesh:
    """for_dx mirrors the loader's handedness conversion
    (`XUSGObjLoader.cpp:198,213,226`): negate z of positions and normals
    and flip triangle winding (OBJ right-handed -> engine left-handed)."""
    positions: list[list[float]] = []
    faces: list[list[int]] = []
    face_vbase: list[int] = []      # vertices parsed before this face
    normals_file: list[list[float]] = []
    nidx: list[list[int]] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                normals_file.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                parts = line.split()[1:]
                # triangulate fans; indices may be v, v/t, v//n, v/t/n
                vs, ns = [], []
                for p in parts:
                    comp = p.split("/")
                    vs.append(int(comp[0]))
                    if len(comp) == 3 and comp[2]:
                        ns.append(int(comp[2]))
                for k in range(1, len(vs) - 1):
                    faces.append([vs[0], vs[k], vs[k + 1]])
                    face_vbase.append(len(positions))
                    if ns:
                        nidx.append([ns[0], ns[k], ns[k + 1]])

    pos = np.asarray(positions, np.float32)
    v_count = pos.shape[0]
    idx = np.asarray(faces, np.int64)
    # Negative vertex indices resolve against the vertices defined *so far*
    # at the face (the loader reads GetNumVertices() live,
    # XUSGObjLoader.cpp:241-242; also the OBJ spec).
    vbase = np.asarray(face_vbase, np.int64)[:, None]
    idx = np.where(idx > 0, idx - 1, vbase + idx).astype(np.int32)
    if for_dx:
        pos[:, 2] = -pos[:, 2]
        for nf in normals_file:
            nf[2] = -nf[2]

    if normals_file and len(nidx) == len(faces):
        # computePerVertexNormals semantics: each vertex carries exactly one
        # file normal (individually normalized); a face referencing the same
        # vertex with a different normal index splits the vertex
        # (XUSGObjLoader.cpp:300-335). Pairing runs on the pre-winding-flip
        # index order, as the reference pairs before its index reverse.
        nrm_src = np.asarray(normals_file, np.float32)
        nl = np.linalg.norm(nrm_src, axis=-1, keepdims=True)
        nrm_src = nrm_src / np.maximum(nl, 1e-20)
        nix = np.asarray(nidx, np.int64)
        # negative normal indices resolve against the file total — the
        # reference passes the first-pass count into loadIndices
        # (XUSGObjLoader.cpp:255-257), unlike vertex indices
        nix = np.where(nix > 0, nix - 1, len(normals_file) + nix).astype(np.int64)

        flat_v = idx.reshape(-1).astype(np.int64)
        flat_n = nix.reshape(-1)
        order = np.arange(flat_v.size, dtype=np.int64)
        first_slot = np.full(v_count, flat_v.size, np.int64)
        np.minimum.at(first_slot, flat_v, order)
        first_n = np.full(v_count, -1, np.int64)
        referenced = first_slot < flat_v.size
        first_n[referenced] = flat_n[first_slot[referenced]]

        keeps = flat_n == first_n[flat_v]
        new_v = flat_v.copy()
        if not keeps.all():
            key = flat_v[~keeps] * (len(normals_file) + 1) + flat_n[~keeps]
            uniq, inv = np.unique(key, return_inverse=True)
            new_v[~keeps] = v_count + inv
            extra_v = (uniq // (len(normals_file) + 1)).astype(np.int64)
            extra_n = (uniq % (len(normals_file) + 1)).astype(np.int64)
            pos = np.concatenate([pos, pos[extra_v]], 0)
        nrm = np.zeros((pos.shape[0], 3), np.float32)
        nrm[:v_count][referenced] = nrm_src[first_n[referenced]]
        if not keeps.all():
            nrm[v_count:] = nrm_src[extra_n]
        idx = new_v.reshape(-1, 3).astype(np.int32)
        if for_dx:
            idx = idx[:, [0, 2, 1]].copy()  # flip winding after pairing
    else:
        if for_dx:
            idx = idx[:, [0, 2, 1]].copy()
        nrm = _accumulate_normals(pos, idx)
        nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / np.maximum(nl, 1e-20)

    verts = np.concatenate([pos, nrm], -1).astype(np.float32)
    return Mesh(
        vertices=verts,
        indices=idx,
        aabb_min=pos.min(0),
        aabb_max=pos.max(0),
    )


def _accumulate_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Unit-face-normal accumulation (`ObjLoader::recomputeNormals`,
    XUSGObjLoader.cpp:337-385 — each face normal is normalized before
    accumulating, i.e. NOT area-weighted)."""
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p1)
    fl = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.maximum(fl, 1e-20)
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, idx[:, k], fn)
    return nrm


