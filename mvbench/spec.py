"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix, and each metric. Every part is a file of its own that
the harness finds by that name, so a later change adds a configuration,
a traffic mix, a metric or a cell by adding files and entries:

* configuration `<c>`: the entry's `file` (`mvbench/configs/<c>.json`);
* traffic mix `<t>`: `mvbench/traffic/<t>.json`;
* cell `<w>`: its correctness limits, `mvbench/limits/<w>.json`;
* metric `<m>`: its reader, `mvbench/metrics/<m>.py`, a module with
  `read(ctx) -> float | None` and, where it reads the operands of an
  entry point of the program, `WRAPS`: [(module, function name)].
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _load_json(self.dir / "limits" / f"{workload}.json")

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metric entries a run of `workload` reports: with `trace`
        the per-layer ones, else the end-to-end ones; each applies to the
        cells its `workloads` lists, or to every cell without the key."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The reader module of `metric`."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "mvbench.metrics." + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def render_config(config: dict) -> dict:
    """A configuration file's `render` fields, lists as tuples (the
    RenderConfig fields are tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["render"].items()}
