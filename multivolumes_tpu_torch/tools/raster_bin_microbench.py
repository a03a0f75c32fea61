"""Primitive-level microbench for a per-tile binned rasterizer.

Counterpart of `tools/raster_bin_microbench.py`. The question it answers
with numbers: would a per-tile binning rasterizer beat the mesh raster's
scatter-min (`render/mesh.py`: one `scatter_reduce_(amin)` of packed
depth words into the screen buffer)?

A binned design for this workload (a bunny-size mesh at demo distance:
about 34k front-facing triangles with a median bounding box under 3 px)
decomposes into three measurable primitives:

1. bin sort: an argsort of one tile key per (triangle, covered tile)
   entry (about 75k entries on 8 x 128 pixel tiles);
2. placement gather: one 16-wide coefficient-row gather into
   chunk-padded, bucket-sorted order;
3. the eval kernel (B6, `ops/raster_bin.py`): every chunk of 128
   candidates evaluates its three affine edge / depth functions over its
   tile's 8 x 128 pixels, packs (z15 | tid17) and min-reduces over the
   candidates and over the chunks of a tile.

The scatter baseline the sum has to beat is measured in the same
process at the raster's shape (334k samples into 1280 x 800 + 1 words).
Emitting the keys and the per-tile count math are charged to neither
side.

Run on the card, from the repository root:

    python -m multivolumes_tpu_torch.tools.raster_bin_microbench

Times are CUDA-event times per call after a warm-up; with `device="cpu"`
(a rehearsal of the flow, not a measurement) they are host-clock times.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from multivolumes_tpu_torch.ops.raster_bin import raster_bin_eval


def _time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean time of one `fn()` in ms over `iters` calls, after one
    warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def eval_inputs(n_chunks: int, n_tiles: int, device, seed: int = 0):
    """The eval kernel's operands at the tool's distribution ->
    (tile_of_chunk, x0, y0, coef): chunks sorted by tile, tile origins
    inside a 384 x 384 window, coefficients of small random triangles."""
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((16, n_chunks * 128)).astype(np.float32) * 0.01
    coef[9] = rng.integers(0, 1 << 17, n_chunks * 128)
    tile_of_chunk = np.sort(rng.integers(0, n_tiles, n_chunks)).astype(
        np.int32)
    x0 = (rng.integers(0, 3, n_chunks) * 128).astype(np.float32)
    y0 = (rng.integers(0, 48, n_chunks) * 8).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (tile_of_chunk, x0, y0, coef))


def main(argv=None, device="cuda") -> dict:
    """Time the four rows and print the table; returns the times in ms as
    {"scatter_min", "argsort", "gather", "eval"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, default=75_000,
                    help="(triangle, tile) entries for sort/gather")
    ap.add_argument("--chunks", type=int, default=600,
                    help="128-candidate chunks for the eval kernel")
    ap.add_argument("--tiles", type=int, default=150,
                    help="distinct output tiles the chunks map onto")
    ap.add_argument("--samples", type=int, default=334_000,
                    help="scatter-min baseline sample count")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the microbench measures the "
                           "card (device='cpu' only rehearses the flow)")

    rng = np.random.default_rng(0)
    n_e, n_c, n_t = args.entries, args.chunks, args.tiles
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    times = {}

    def timed(key, name, fn):
        times[key] = _time_ms(fn, args.iters, device)
        print(f"{name:34s} {times[key]:8.3f} ms   ({args.iters} iters, "
              f"{clock})")

    # --- baseline: the raster's scatter-min of packed depth words --------
    pix = torch.from_numpy(rng.integers(0, 800 * 1280, args.samples)).to(
        device)
    val = torch.from_numpy(rng.integers(0, 1 << 31, args.samples)).to(device)

    def scatter_min():
        buf = torch.full((800 * 1280 + 1,), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=device)
        return buf.scatter_reduce_(0, pix, val, "amin")

    timed("scatter_min", f"scatter_min {args.samples / 1e3:.0f}k",
          scatter_min)

    # --- primitive 1: bin sort -------------------------------------------
    keys = torch.from_numpy(rng.integers(0, n_t, n_e).astype(np.int32)).to(
        device)
    timed("argsort", f"argsort {n_e / 1e3:.0f}k i32",
          lambda: torch.argsort(keys))

    # --- primitive 2: placement row gather -------------------------------
    tbl = torch.from_numpy(
        rng.standard_normal((n_e, 16)).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, n_e, n_c * 128)).to(device)
    timed("gather", f"row gather {n_c * 128 / 1e3:.1f}k x16",
          lambda: tbl[idx])

    # --- primitive 3: the eval kernel (B6) -------------------------------
    operands = eval_inputs(n_c, n_t, device)
    timed("eval", f"eval kernel {n_c} chunks",
          lambda: raster_bin_eval(*operands, n_t))

    total = times["argsort"] + times["gather"] + times["eval"]
    t_scatter = times["scatter_min"]
    print("-" * 50)
    print(f"binned total (sort+gather+eval)    {total:8.3f} ms"
          f"   vs scatter-min {t_scatter:.3f} ms"
          f"   ({'WINS' if total < t_scatter else 'LOSES'},"
          f" delta {t_scatter - total:+.3f} ms; emit/key prep and"
          f" per-tile count math not yet charged to either side)")
    return times


if __name__ == "__main__":
    main()
