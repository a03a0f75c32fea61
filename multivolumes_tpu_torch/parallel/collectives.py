"""The device mesh and the three movements of the sharded frame step.

The JAX package states shardings and lets GSPMD place the collectives;
PyTorch has no such compiler, so the port states the same plan explicitly,
in one process that drives every device (the counterpart of JAX's single
controller). Every cross-shard movement of the sharded step goes through
`all_gather`, `halo_rows` or `broadcast` below, and each call appends
`(name, elems, bytes)` to `mesh.log`, so a run can show what moved
(`sharding.placement_check`). A later change can put NCCL behind these
three functions without touching the passes.

A mesh may name the same `torch.device` several times: *logical shards*,
the counterpart of `--xla_force_host_platform_device_count`. They are how
the CPU tests and a one-card machine run D > 1. Between logical shards of
one device a movement is a `torch.cat` or a view; between distinct devices
it is `.to(dev, non_blocking=True)` with an event that the consumer's
stream waits on.

A *replicated* value is a dict {physical device: value}, one entry per
distinct device of the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A 1-D ("volumes",) or 2-D ("rows", "volumes") mesh of devices."""
    axis_names: tuple
    shape: dict              # axis name -> size
    devices: tuple           # row-major (rows, volumes) torch.devices
    log: list = dataclasses.field(default_factory=list, compare=False)

    @property
    def rows(self) -> int:
        return self.shape.get("rows", 1)

    @property
    def n_volumes_axis(self) -> int:
        return self.shape["volumes"]

    def device(self, r: int, d: int) -> torch.device:
        return self.devices[r * self.n_volumes_axis + d]

    @property
    def physical(self) -> tuple:
        """The distinct devices, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def root(self) -> torch.device:
        """Where the image is assembled."""
        return self.devices[0]


def to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`x` on `dev`: itself when it lies there, else an asynchronous copy
    ordered after the producer's stream on the consumer's stream."""
    if x.device == dev:
        return x
    y = x.to(dev, non_blocking=True)
    if x.is_cuda and dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
        torch.cuda.current_stream(dev).wait_event(done)
    return y


def _map(fn, x):
    """Apply `fn` to a tensor or to every tensor of a (named) tuple."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    return tuple(_map(fn, v) for v in x)


def _tensors(x):
    """The tensors of a tensor or of a (nested) tuple of tensors."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _tensors(v)]


def _sizes(tensors) -> tuple:
    """(elements, bytes) of a list of tensors."""
    return (sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


def all_gather(parts: Sequence[torch.Tensor], axis: int, mesh: DeviceMesh,
               name: str, devices=None) -> dict:
    """Concatenate the shards `parts` along `axis`, in shard order, onto
    every physical device of the mesh (or only `devices`) -> replicated
    dict."""
    mesh.log.append((name, *_sizes(parts)))
    return {dev: torch.cat([to_device(p, dev) for p in parts], dim=axis)
            for dev in (mesh.physical if devices is None else devices)}


def halo_rows(bands: Sequence[torch.Tensor], mesh: DeviceMesh) -> list:
    """Row bands (C, hb_r, W) of one image, in row order -> each band
    with one row above and one below, (C, hb_r + 2, W), on its row's
    device `mesh.device(r, 0)`. Interior halos come from the neighbour
    band; the first band's top row and the last band's bottom row are
    replicated (edge padding). The log counts the rows that crossed
    between shards."""
    out = []
    last = len(bands) - 1
    for r, band in enumerate(bands):
        dev = mesh.device(r, 0) if mesh.rows > 1 else mesh.root
        top = bands[r - 1][:, -1:] if r > 0 else band[:, :1]
        bot = bands[r + 1][:, :1] if r < last else band[:, -1:]
        out.append(torch.cat([to_device(top, dev), to_device(band, dev),
                              to_device(bot, dev)], dim=1))
    c, _, w = bands[0].shape
    mesh.log.append(("halo_rows", 2 * last * c * w,
                     2 * last * c * w * bands[0].element_size()))
    return out


def broadcast(x, mesh: DeviceMesh, name: str = "broadcast") -> dict:
    """A tensor (or a tuple of tensors) -> replicated dict holding it on
    every physical device of the mesh."""
    mesh.log.append((name, *_sizes(_tensors(x))))
    return {dev: _map(lambda t: to_device(t, dev), x)
            for dev in mesh.physical}
