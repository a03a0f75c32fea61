"""Screen-to-face projective geometry and the warp composite.

Counterpart of `multivolumes_tpu/render/warp.py`. For one volume and one
exit face the map from screen NDC q = [x, y, 1] to face coordinates is a
homography, u = (nu.q)/(den.q), v = (nv.q)/(den.q). The tile composite
(kernel B2) evaluates it as a Catmull-Smith two-pass resample whose pass
order per face is chosen by `catmull_swap_flags`; that one function
serves both the sweep's bucket assembly (which emits faces pre-swapped)
and the tile prep, so the two can never disagree.

`composite_oit_warp` (`composite_mode="warp"`) resamples each volume's
faces onto a screen tile around it with two tent-matrix products a face
(`warp_face`) and inserts the tile into the nearest-K layers. Where the
JAX function branches on device values (`lax.cond` on a volume's
visibility, on whether a face covers any pixel, on a face's resample
orientation and on the pass-2 formulation), this one reads the
visibility of a footprint class once and the 18 flags of each visible
volume once from the device, and branches on the host; the arithmetic of
each branch is the JAX function's.
"""

from __future__ import annotations

import torch


_EPS = 1e-12

# face -> (axis, sign, (u axis, u coeff), (v axis, v coeff)) matching
# `GetLocalPos` (`CSRayMarch.hlsl:28-53`): u = 0.5 + cu * e[bu], ...
_FACES = (
    (0, +1.0, (2, -0.5), (1, -0.5)),   # +X
    (0, -1.0, (2, +0.5), (1, -0.5)),   # -X
    (1, +1.0, (0, +0.5), (2, +0.5)),   # +Y
    (1, -1.0, (0, +0.5), (2, -0.5)),   # -Y
    (2, +1.0, (0, +0.5), (1, -0.5)),   # +Z
    (2, -1.0, (0, -0.5), (1, -0.5)),   # -Z
)


def screen_basis(screen_to_world, eye):
    """(3, 3) matrix A with d_world = [x_ndc, y_ndc, 1] @ A (the
    mid-depth unprojection of `composite.screen_rays`, kept homogeneous)."""
    m = screen_to_world
    rows = [m[0], m[1], 0.5 * m[2] + m[3]]
    return torch.stack([r[:3] - eye * r[3] for r in rows])


def face_homography(b_mat, o, face: int):
    """Homography coefficient vectors (nu, nv, den), each (..., 3), for one
    exit face. b_mat: (..., 3, 3) with d_local = q @ b_mat; o: (..., 3)
    local eye."""
    a, s, (bu, cu), (bv, cv) = _FACES[face]
    den = b_mat[..., :, a]

    def exit_num(comp):
        # e_comp numerator: o_comp * d_a + (s - o_a) * d_comp
        return (o[..., comp, None] * den
                + (s - o[..., a, None]) * b_mat[..., :, comp])

    nu = 0.5 * den + cu * exit_num(bu)
    nv = 0.5 * den + cv * exit_num(bv)
    return nu, nv, den


def local_basis(a_mat, world_i):
    """(N, 3, 3) B = A @ world_i[:3, :3]: d_local = q @ B."""
    return torch.einsum("ij,njk->nik", a_mat, world_i[:, :3, :3])


def catmull_swap_flags(a_mat, world_i, world_view_proj, eye_local, n_eff):
    """(N, 6) bool per-(volume, face) Catmull-Smith resample-axis choice:
    True = the face image is consumed transposed. Picks whichever face
    axis varies more with screen y at the volume's projected centre."""
    b_mat = local_basis(a_mat, world_i)
    c0 = world_view_proj[:, 3, :]
    c0w = torch.where(c0[:, 3].abs() > 1e-3, c0[:, 3], 1e-3)
    xc = torch.clamp(c0[:, 0] / c0w, -1.0, 1.0)
    yc = torch.clamp(c0[:, 1] / c0w, -1.0, 1.0)
    swaps = []
    for f in range(6):
        nu, nv, den = face_homography(b_mat, eye_local, f)
        p_u = n_eff[:, None] * nu - 0.5 * den
        p_v = n_eff[:, None] * nv - 0.5 * den
        dqc = den[:, 0] * xc + den[:, 1] * yc + den[:, 2]
        vqc = p_v[:, 0] * xc + p_v[:, 1] * yc + p_v[:, 2]
        uqc = p_u[:, 0] * xc + p_u[:, 1] * yc + p_u[:, 2]
        dv_dy = p_v[:, 1] * dqc - den[:, 1] * vqc
        du_dy = p_u[:, 1] * dqc - den[:, 1] * uqc
        swaps.append(dv_dy.abs() < du_dy.abs())
    return torch.stack(swaps, dim=1)


def _safe(x, eps=_EPS):
    return torch.where(x.abs() > eps, x, torch.where(x >= 0, eps, -eps))


