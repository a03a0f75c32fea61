"""DDS texture import: `parse_dds` and `load_dds`.

Counterpart of the readers of `multivolumes_tpu/scene/io_dds.py`, a
behavioural port of `XUSG::DDS::Loader` (`XUSG/Advanced/XUSGDDSLoader.h:
21-38`) for the formats the reference loads: R32_FLOAT 3D density volumes
(`MultiRayCaster::LoadVolumeData`, `MultiRayCaster.cpp:168-209`) and
RGBA16F/RGBA32F cube maps (`LightProbe::Init` radiance environment). It
returns numpy arrays; `scene.volume.r32f_to_rgba` converts a density to
the engine's layout as the reference's `CSR32FToRGBA16F` dispatch does.

The writers, `write_dds_r32f_volume` and `write_dds_rgba16f_cube`, write
the files the JAX package's writers write, byte for byte (round-trip
tests, exporting procedural volumes and environments).

A copy and not an import: importing the JAX package's `scene` imports its
state module, and with it JAX.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

DDS_MAGIC = 0x20534444  # 'DDS '

# dwFlags
DDSD_DEPTH = 0x800000
# dwCaps2
DDSCAPS2_CUBEMAP = 0x200
DDSCAPS2_VOLUME = 0x200000

# DXGI formats we support
DXGI_R32_FLOAT = 41
DXGI_R16G16B16A16_FLOAT = 10
DXGI_R32G32B32A32_FLOAT = 2
DXGI_R8G8B8A8_UNORM = 28
DXGI_B8G8R8A8_UNORM = 87
DXGI_R16_FLOAT = 54

_DTYPES = {
    DXGI_R32_FLOAT: (np.float32, 1),
    DXGI_R16_FLOAT: (np.float16, 1),
    DXGI_R16G16B16A16_FLOAT: (np.float16, 4),
    DXGI_R32G32B32A32_FLOAT: (np.float32, 4),
    DXGI_R8G8B8A8_UNORM: (np.uint8, 4),
    DXGI_B8G8R8A8_UNORM: (np.uint8, 4),
}


class DDSTexture(NamedTuple):
    data: np.ndarray        # mip 0. volume: (D, H, W, C); cube: (6, H, W, C); 2D: (H, W, C)
    is_cube: bool
    is_volume: bool
    dxgi_format: int
    mip_count: int
    mips: tuple = ()        # full chain, mips[0] is `data`
      # (`XUSGDDSLoader.h:21-38` uploads every mip; the engine consumes
      # mip 0 for densities and the chain for radiance imports)


def _fourcc(code: bytes) -> int:
    return struct.unpack("<I", code)[0]


def load_dds(path: str) -> DDSTexture:
    with open(path, "rb") as f:
        raw = f.read()
    return parse_dds(raw)


def parse_dds(raw: bytes) -> DDSTexture:
    if len(raw) < 128 or struct.unpack("<I", raw[:4])[0] != DDS_MAGIC:
        raise ValueError("not a DDS file")

    (size, flags, height, width, _pitch, depth, mip_count) = struct.unpack(
        "<7I", raw[4:32]
    )
    if size != 124:
        raise ValueError("bad DDS header size")
    mip_count = max(mip_count, 1)

    pf_flags, pf_fourcc = struct.unpack("<2I", raw[80:88])
    pf_rgb_bit_count, r_mask, g_mask, b_mask, a_mask = struct.unpack(
        "<5I", raw[88:108]
    )
    caps2 = struct.unpack("<I", raw[112:116])[0]

    offset = 128
    dxgi = None
    array_size = 1
    if pf_flags & 0x4 and pf_fourcc == _fourcc(b"DX10"):
        dxgi, _dim, misc, array_size, _misc2 = struct.unpack(
            "<5I", raw[128:148]
        )
        offset = 148
        is_cube = bool(misc & 0x4)
    else:
        is_cube = bool(caps2 & DDSCAPS2_CUBEMAP)
        # legacy FourCC / masked formats
        if pf_flags & 0x4:
            legacy = {
                114: DXGI_R32_FLOAT,        # D3DFMT_R32F
                113: DXGI_R16G16B16A16_FLOAT,  # D3DFMT_A16B16G16R16F
                116: DXGI_R32G32B32A32_FLOAT,  # D3DFMT_A32B32G32R32F
                111: DXGI_R16_FLOAT,        # D3DFMT_R16F
            }.get(pf_fourcc)
            if legacy is None:
                raise ValueError(f"unsupported DDS FourCC {pf_fourcc:#x}")
            dxgi = legacy
        elif pf_flags & 0x40 and pf_rgb_bit_count == 32:
            dxgi = (
                DXGI_R8G8B8A8_UNORM if r_mask == 0xFF else DXGI_B8G8R8A8_UNORM
            )
        else:
            raise ValueError("unsupported legacy DDS pixel format")

    if dxgi not in _DTYPES:
        raise ValueError(f"unsupported DXGI format {dxgi}")
    dtype, channels = _DTYPES[dxgi]
    texel = np.dtype(dtype).itemsize * channels

    is_volume = bool(flags & DDSD_DEPTH) or bool(caps2 & DDSCAPS2_VOLUME)
    depth = depth if is_volume else 1
    faces = 6 if is_cube else 1

    def mip_bytes(w, h, d):
        return max(w, 1) * max(h, 1) * max(d, 1) * texel

    # Per face/array element, mips are stored consecutively.
    out_faces = []          # out_faces[face][mip]
    pos = offset
    for _face in range(faces):
        w, h, d = width, height, depth
        face_mips = []
        for _m in range(mip_count):
            nbytes = mip_bytes(w, h, d)
            buf = np.frombuffer(
                raw, dtype=dtype,
                count=nbytes // np.dtype(dtype).itemsize, offset=pos)
            if is_volume:
                face_mips.append(
                    buf.reshape(max(d, 1), max(h, 1), max(w, 1), channels))
            else:
                face_mips.append(
                    buf.reshape(max(h, 1), max(w, 1), channels))
            pos += nbytes
            w, h, d = max(w // 2, 1), max(h // 2, 1), max(d // 2, 1)
        out_faces.append(face_mips)

    def fix_bgra(a):
        return a[..., [2, 1, 0, 3]] if dxgi == DXGI_B8G8R8A8_UNORM else a

    if is_cube:
        mips = tuple(
            fix_bgra(np.stack([out_faces[f][m] for f in range(6)]))
            for m in range(mip_count)
        )
        return DDSTexture(mips[0], True, False, dxgi, mip_count, mips)
    mips = tuple(fix_bgra(m) for m in out_faces[0])
    return DDSTexture(mips[0], False, is_volume, dxgi, mip_count, mips)


def _box_down(a: np.ndarray) -> np.ndarray:
    """2x (2x2x2 for volumes) box-filter downsample, odd dims clamped."""
    vol = a.ndim == 4
    if vol:
        d, h, w = a.shape[:3]
        a = a[: d - d % 2 or None, : h - h % 2 or None, : w - w % 2 or None]
        a = a.reshape(max(d // 2, 1), min(2, d), max(h // 2, 1), min(2, h),
                      max(w // 2, 1), min(2, w), a.shape[-1])
        return a.mean(axis=(1, 3, 5), dtype=np.float64).astype(a.dtype)
    h, w = a.shape[:2]
    a = a[: h - h % 2 or None, : w - w % 2 or None]
    a = a.reshape(max(h // 2, 1), min(2, h), max(w // 2, 1), min(2, w),
                  a.shape[-1])
    return a.mean(axis=(1, 3), dtype=np.float64).astype(a.dtype)


def write_dds_r32f_volume(path: str, volume: np.ndarray,
                          mip_count: int = 1) -> None:
    """Write a (D, H, W) float32 density grid as an R32F volume DDS with an
    optional box-filtered mip chain."""
    volume = np.ascontiguousarray(volume, np.float32)
    d, h, w = volume.shape
    header = bytearray(128)
    struct.pack_into("<I", header, 0, DDS_MAGIC)
    # size, flags (CAPS|HEIGHT|WIDTH|PIXELFORMAT|DEPTH|LINEARSIZE|MIPCOUNT)
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | DDSD_DEPTH | 0x80000
    if mip_count > 1:
        flags |= 0x20000
    struct.pack_into("<7I", header, 4, 124, flags, h, w, w * 4, d, mip_count)
    # pixel format: size 32, flags FOURCC, fourcc D3DFMT_R32F (114)
    struct.pack_into("<II", header, 76, 32, 0x4)
    struct.pack_into("<I", header, 84, 114)
    caps = 0x1000 | 0x8 | (0x400000 if mip_count > 1 else 0)
    struct.pack_into("<I", header, 108, caps)  # TEXTURE|COMPLEX|MIPMAP
    struct.pack_into("<I", header, 112, DDSCAPS2_VOLUME)
    with open(path, "wb") as f:
        f.write(bytes(header))
        m = volume[..., None]
        for i in range(mip_count):
            f.write(np.ascontiguousarray(m, np.float32).tobytes())
            if i + 1 < mip_count:
                m = _box_down(m)


def write_dds_rgba16f_cube(path: str, cube: np.ndarray,
                           mip_count: int = 1) -> None:
    """Write a (6, R, R, 4) cube map as RGBA16F DDS (DX10 header, the
    layout the reference's radiance environments use)."""
    cube = np.ascontiguousarray(cube, np.float16)
    _, h, w = cube.shape[:3]
    header = bytearray(148)
    struct.pack_into("<I", header, 0, DDS_MAGIC)
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | (0x20000 if mip_count > 1 else 0)
    struct.pack_into("<7I", header, 4, 124, flags, h, w, w * 8, 0, mip_count)
    struct.pack_into("<II", header, 76, 32, 0x4)
    struct.pack_into("<I", header, 84, _fourcc(b"DX10"))
    caps = 0x1000 | 0x8 | (0x400000 if mip_count > 1 else 0)
    struct.pack_into("<I", header, 108, caps)
    struct.pack_into("<I", header, 112, DDSCAPS2_CUBEMAP | 0xFC00)  # all faces
    # DX10: dxgi, dimension TEXTURE2D (3), misc TEXTURECUBE (0x4), array 1
    struct.pack_into("<5I", header, 128, DXGI_R16G16B16A16_FLOAT, 3, 0x4, 1, 0)
    with open(path, "wb") as f:
        f.write(bytes(header))
        for face in range(6):
            m = cube[face]
            for i in range(mip_count):
                f.write(np.ascontiguousarray(m, np.float16).tobytes())
                if i + 1 < mip_count:
                    m = _box_down(m)
