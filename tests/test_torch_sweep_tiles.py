"""What the B1 kernel's shared-memory staging relies on, on the CPU.

The CUDA kernel (`multivolumes_tpu_torch/csrc/sweep.cu`) cannot run here,
so its index arithmetic is mirrored by plain functions in
`multivolumes_tpu_torch/ops/sweep.py`:

* `tile_rect`: the rectangle of slab texels a 16 x 16 tile of rays taps on
  plane k. The kernel stages exactly that rectangle and lets every ray of
  the tile read its taps from it without a test of its own, so every tap
  of every ray must lie inside it: for eyes outside, near and inside the
  cube, all six faces with their mirrors, n_eff = S, S/2, S/4, the
  density grid and the light grid.
* `sweep_march_rays_plain`: the march in the kernel's per-ray gather form
  and operation order (z-lerp per texel, 2-tap u pass rounded, 2-tap v
  pass), against `sweep_march_plain` and the JAX twin.

    python -m pytest tests/test_torch_sweep_tiles.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_sweep import TOL, _b1_case, _port_light
from torch_parity import n, t

from multivolumes_tpu.render import sweep as jsw
from multivolumes_tpu_torch.ops import sweep as psw_ops
from multivolumes_tpu_torch.render import sweep as psw

S = 32            # face side: 2 x 2 tiles of 16 x 16 rays
P = 32            # planes
EYES = {"outside": (0.3, -0.4, -2.5), "near": (1.02, -0.98, 1.05),
        "inside": (0.2, 0.1, 0.3)}
GRIDS = {"density": 32, "light": 24}
NO_CAP = (1 << 20, 1 << 20)


def _face_frames(eye):
    return psw.eye_to_face_frames(torch.tensor([eye])).numpy()[0]   # (6, 3)


def _uncovered(eye, n_eff, grid, planes=range(P)):
    """Taps of the rays of every tile, face and plane that fall outside
    the tile's `tile_rect` -> list of (face, plane, tile, what)."""
    bad = []
    for face, eye_f in enumerate(_face_frames(eye)):
        flips = psw_ops.FACE_FLIPS[face]
        for k in planes:
            _wk, sk = psw_ops.plane_sk(eye_f[2], k, P)
            for i_lo in range(0, S, psw_ops.TILE):
                for j_lo in range(0, S, psw_ops.TILE):
                    i_hi, j_hi = i_lo + psw_ops.TILE - 1, \
                        j_lo + psw_ops.TILE - 1
                    rect = psw_ops.tile_rect(eye_f, k, P, n_eff, grid, flips,
                                             i_lo, i_hi, j_lo, j_hi,
                                             cap=NO_CAP)
                    y_lo, y_hi, x_lo, x_hi = rect
                    rows = np.arange(i_lo, i_hi + 1)
                    cols = np.arange(j_lo, j_hi + 1)
                    y0, y1 = psw_ops.axis_taps(
                        eye_f[1], sk, -psw_ops.texel_centres(rows, n_eff),
                        grid, flips[1])
                    x0, x1 = psw_ops.axis_taps(
                        eye_f[0], sk, psw_ops.texel_centres(cols, n_eff),
                        grid, flips[2])
                    if y0.min() < y_lo or y1.max() > y_hi \
                            or x0.min() < x_lo or x1.max() > x_hi:
                        bad.append((face, k, (i_lo, j_lo), rect,
                                    (y0.min(), y1.max(), x0.min(),
                                     x1.max())))
                    assert 0 <= y_lo <= y_hi < grid \
                        and 0 <= x_lo <= x_hi < grid, rect
    return bad


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n_eff", [S, S // 2, S // 4])
@pytest.mark.parametrize("eye", list(EYES))
def test_tile_rect_holds_every_tap(eye, n_eff, grid):
    assert _uncovered(EYES[eye], float(n_eff), GRIDS[grid]) == []


@settings(max_examples=40, deadline=None)
@given(st.tuples(*[st.floats(-3.0, 3.0, width=32)] * 3),
       st.sampled_from([S, S // 2, S // 4]), st.sampled_from([32, 24, 7]),
       st.integers(0, P - 1))
def test_tile_rect_holds_every_tap_anywhere(eye, n_eff, grid, k):
    assert _uncovered(eye, float(n_eff), grid, planes=[k]) == []


def test_tile_rect_fits_the_buffers_at_the_top_lod():
    """At n_eff = S on grids of the face's resolution (and 3/4 of it for
    the light, as the demo has them) a tile of an eye outside the cube
    stages every plane; at n_eff = S / 4 its rectangle exceeds the buffer
    and the tile marches by the direct fetch."""
    eye_f = _face_frames(EYES["outside"])[4]
    flips = psw_ops.FACE_FLIPS[4]
    for k in range(P):
        assert psw_ops.tile_rect(eye_f, k, P, float(S), S, flips, 0, 15, 0,
                                 15) is not None
        assert psw_ops.tile_rect(eye_f, k, P, float(S), 24, flips, 0, 15, 0,
                                 15, cap=psw_ops.STAGE_LIGHT) is not None
    assert psw_ops.tile_rect(eye_f, P - 1, P, float(S // 4), 4 * S, flips, 0,
                             15, 0, 15) is None
    assert psw_ops.tile_rect(eye_f, 0, P, float(S), S, flips, 3, 2, 0,
                             15) is None          # a tile without a row


def _port_args(dtype):
    (vols, lights, tex, eye_faces, params, smp, run, n_eff, light_ids,
     s) = _b1_case()
    args = (t(vols, dtype), _port_light(lights).to(dtype),
            torch.from_numpy(tex), t(eye_faces),
            psw.SweepParams(*(torch.from_numpy(np.asarray(x))
                              for x in params)),
            torch.from_numpy(np.asarray(smp)),
            torch.from_numpy(np.asarray(run)), s, s)
    kw = dict(n_eff_b=t(n_eff), light_ids=torch.from_numpy(light_ids))
    return args, kw


def test_rays_plain_matches_plane_resample_f32():
    args, kw = _port_args(torch.float32)
    got = psw_ops.sweep_march_rays_plain(*args, **kw)
    want = psw_ops.sweep_march_plain(*args, **kw)
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_rays_plain_matches_plane_resample_bf16():
    """In bf16 the two forms round at the same places; the texels beyond
    the kernel's limit (atol 2e-3 + rtol 2e-2) are counted and held at 0
    at this size."""
    args, kw = _port_args(torch.bfloat16)
    got = psw_ops.sweep_march_rays_plain(*args, **kw)
    want = psw_ops.sweep_march_plain(*args, **kw)
    beyond = (got - want).abs() > TOL["atol"] + TOL["rtol"] * want.abs()
    assert int(beyond.sum()) == 0, int(beyond.sum())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rays_plain_matches_jax_twin(dtype):
    (vols, lights, tex, eye_faces, params, smp, run, n_eff, light_ids,
     s) = _b1_case()
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    vol_or = jsw.orient_variants(jnp.asarray(vols, jdt))
    light_or = jsw.orient_variants_cf(jnp.asarray(lights, jdt))
    want = jax.jit(lambda a, b: jsw.sweep_batched(
        a, b, jnp.asarray(tex), eye_faces, params, smp, run, s, s, dtype=jdt,
        n_eff_b=jnp.asarray(n_eff), light_ids=jnp.asarray(light_ids)))(
            vol_or, light_or)
    args, kw = _port_args(pdt)
    got = psw_ops.sweep_march_rays_plain(*args, **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_mirror_constants_are_the_kernels():
    """The constants of the Python mirror are read off `csrc/sweep.cu`."""
    import re

    from multivolumes_tpu_torch.ops import build

    src = (build.CSRC / "sweep.cu").read_text()

    def const(name):
        return re.search(rf"\b{name} = ([\w.+-]+?)f?[;,]", src).group(1)

    threads = int(const("kTile")) ** 2
    assert int(const("kTile")) == psw_ops.TILE
    assert float(const("kRectPad")) == psw_ops.RECT_PAD
    vol_pitch, light_pitch = (1 << int(const("kVolPitchLog2")),
                              1 << int(const("kLightPitchLog2")))
    assert (int(const("kVolRounds")) * threads // vol_pitch,
            vol_pitch) == psw_ops.STAGE_VOL
    assert (int(const("kLightRounds")) * threads // light_pitch,
            light_pitch) == psw_ops.STAGE_LIGHT
