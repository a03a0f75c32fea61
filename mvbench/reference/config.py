"""Engine configuration: the reference's constants and CLI defaults.

The port's own copy of `multivolumes_tpu/config.py` (the port imports
nothing of the JAX package). The fields, their names and defaults, and
the constants are the same, so a configuration carries across between
the two packages field by field (`tests/test_torch_core.py` holds them
equal). Reference: `Content/SharedConsts.h:5-10` and the hand-parsed CLI
defaults of `MultiVolumes/MultiVolumes.cpp:27-68,543-613`.
"""

from __future__ import annotations

import dataclasses
import math


class SharedConsts:
    """Compile-time constants shared by host and kernels
    (`SharedConsts.h:5-10`, `RayMarch.hlsli:11-17`)."""

    GROUP_VOLUME_COUNT = 4
    NUM_CUBE_MIP = 5
    NUM_OIT_LAYERS = 8
    Z_NEAR = 1.0
    Z_FAR = 1000.0

    ABSORPTION = 0.8
    ZERO_THRESHOLD = 0.01
    MAX_DIST = 2.0 * math.sqrt(3.0)  # diameter of the [-1,1]^3 cube

    # Render scheme bit in VolumeInfo.MaskBits (`Common.hlsli:12`)
    CUBEMAP_RAYMARCH_BIT = 1 << 15

    FOV_ANGLE_Y = math.pi / 4.0  # `MultiVolumes.cpp` g_FOVAngleY


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Scene and engine settings, mirroring the reference CLI."""

    width: int = 1280
    height: int = 800

    grid_size: int = 128        # -gridSize: density volume resolution
    light_grid_size: int = 96   # -lightGridSize: light map resolution
    max_ray_samples: int = 256  # -maxRaySamples
    max_light_samples: int = 96  # -maxLightSamples
    num_volumes: int = 2        # -numVolumes (2..64 in demos)
    # distinct source density textures the volumes cycle through
    num_volume_srcs: int = 2

    cube_map_size: int = 128    # per-volume cube-map top-mip resolution
    num_cube_mips: int = SharedConsts.NUM_CUBE_MIP
    oit_layers: int = SharedConsts.NUM_OIT_LAYERS

    # -volume x y z scale and -mesh file x y z scale (`MultiVolumes.cpp:
    # 38-39,55,59`)
    vol_pos_scale: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 10.0)
    mesh_pos_scale: tuple[float, float, float, float] = (0.0, -9.0, 0.0, 1.8)

    show_mesh: bool = False
    has_light_probe: bool = True
    # `_POINT_LIGHT_` (`CSRayMarchL.hlsl:87-92`): needs the reference
    # light march
    point_light: bool = False
    adaptive_raymarch: bool = True  # `_ADAPTIVE_RAYMARCH_`, Common.hlsli:13

    shadow_map_size: int = 1024  # `ObjectRenderer.cpp:80-83`

    # sweep stacks in bfloat16 (the reference computes in min16float);
    # False keeps them in f32
    use_bf16: bool = True

    # view march: "sweep" (plane-sweep cube maps) or "reference" (the
    # per-ray march of `CSRayMarch.hlsl`)
    march_mode: str = "sweep"
    sweep_planes: int | None = None  # None -> cube_map_size
    # light maps: "sweep" (shear-warp) or "reference" (gather march)
    light_mode: str = "sweep"
    # light-map volumes refreshed per frame, round-robin (1 = the
    # reference's cadence, `CSRayMarchL.hlsl:31-32`; 0 = all)
    light_refresh: int = 1
    # shear-warp sweep axis, baked on the host from the light direction
    # (engine); None picks it from the light position
    light_axis: int | None = None
    # multi-device: shard the per-volume light stacks over the devices
    shard_light_stacks: bool = False
    # f16-pair cube packing for the gather composite
    packed_composite: bool = True
    # LOD bucket capacities for the sweep (bucket i at cube_map_size >> i);
    # None disables LOD bucketing
    lod_bucket_caps: tuple | None = (8, 24, 1 << 30)
    # screen composite: "auto"/"tile" (screen-tile kernel), "warp",
    # "gather"
    composite_mode: str = "auto"
    # per-volume screen tile of the warp composite (None -> by count)
    warp_tile: int | None = None
    # sky pass resolution divisor
    sky_scale: int = 8
    # backface-cull the mesh raster (the reference's default CULL_BACK);
    # False for open single-sided geometry
    mesh_backface_cull: bool = True
    # raster small-triangle tail (frac, kk): the smallest `frac` of the
    # emitted triangles sample at kk x kk instead of 4 x 4
    raster_tail: tuple | None = (0.6, 2)
    # raster tier ladder: "near" (all distances) or "far" (the mesh's
    # demo-distance ladder, valid while its projected bbox stays within
    # raster_far_bound px); picked per frame on the host
    # (engine.select_raster_preset)
    raster_preset: str = "near"
    # the far ladder and its small end, derived at set_mesh
    # (mesh.derive_far_tiers); None = far preset unavailable
    raster_far_tiers: tuple | None = None
    raster_far_small: tuple | None = None
    # projected-bbox bound (px) of the far ladder
    raster_far_bound: int = 360
    # window (px) of the TAA history reprojection around the mesh, far
    # preset only; 0 = full screen
    taa_reproj_window: int = 416
    # window (px) of the mesh's deferred shade, far preset only
    mesh_shade_window: int = 384
    # isfinite guards in the frame (debug)
    debug_finite: bool = False
    # composite at 1/composite_scale resolution and upsample (1 = full)
    composite_scale: int = 1

    @property
    def viewport(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def with_(self, **kwargs) -> "RenderConfig":
        return dataclasses.replace(self, **kwargs)
