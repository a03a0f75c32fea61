"""A copy of the benchmark's files at a size the CPU runs in seconds:
the real `BENCHMARK.json`, metric readers and traffic mixes, and a
configuration `tiny` (96x64, grid 16, 4 volumes, a 500-triangle torus)
in place of each real one, under a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from mvbench.spec import HERE, ROOT, Spec

TINY = dict(width=96, height=64, grid_size=16, light_grid_size=8,
            max_ray_samples=16, max_light_samples=8, num_volumes=4,
            num_volume_srcs=2, cube_map_size=16, shadow_map_size=64,
            lod_bucket_caps=[1, 2, 1073741824])


def tiny_spec(tmp: Path, limits: dict | None = None) -> Spec:
    """The tiny copy under `tmp`; every cell's limits are `limits` (the
    real cell's limits when None)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp / "mvbench"
    for sub in ("metrics", "traffic"):
        shutil.copytree(HERE / sub, d / sub)
    (d / "configs").mkdir()
    (d / "limits").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["render"].update(TINY)
        cfg["mesh_triangles"] = 500
        c["file"] = f"mvbench/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        lim = limits if limits is not None else json.loads(
            (HERE / "limits" / f"{w['name']}.json").read_text())
        (d / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(tmp, d)
