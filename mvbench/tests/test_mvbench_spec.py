"""BENCHMARK.json against the contract, and its parts found by name."""

import json
import re

import pytest

from mvbench import spec as spec_lib
from mvbench.spec import HERE, ROOT, Spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mvbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(cells) == len(set(cells))
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("mvbench/") and c["reduced"] == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_parts(cell):
    spec = Spec()
    w = spec.workload(cell)
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    assert set(traffic) == {"camera", "mesh", "frames_in_flight",
                            "delivery"}
    assert cfg["render"]["width"] == 1280
    assert spec.limits(cell)
    for trace in (False, True):
        for m in spec.metrics(cell, trace):
            assert callable(spec.reader(m["name"]).read)


def test_every_metric_has_its_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_cell_is_taken_up_from_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell by adding files and entries, and edits no file."""
    import shutil

    root = tmp_path
    shutil.copytree(HERE, root / "mvbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "mvbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((HERE / "configs" / "all16.json").read_text())
    cfg["render"]["num_volumes"] = 4
    (root / "mvbench/configs/all4.json").write_text(json.dumps(cfg))
    traffic = json.loads((HERE / "traffic" / "orbit.json").read_text())
    traffic["camera"]["time_step"] = 0.0
    (root / "mvbench/traffic/static.json").write_text(json.dumps(traffic))
    (root / "mvbench/limits/all4.static.json").write_text('{"hdr_max": 1}')
    (root / "mvbench/metrics/frames.json_count.py").write_text(
        "def read(ctx):\n    return len(ctx.window)\n")
    bench["configs"].append(dict(bench["configs"][0], name="all4",
                                 file="mvbench/configs/all4.json"))
    bench["workloads"].append({"name": "all4.static", "config": "all4",
                               "traffic": "static", "chips": 1,
                               "why": "paused"})
    bench["per_layer"].append({"name": "frames.json_count", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "frame", "moves": "fps",
                               "workloads": ["all4.static"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root, root / "mvbench")
    assert spec.config("all4")["render"]["num_volumes"] == 4
    assert spec.traffic("static")["camera"]["time_step"] == 0.0
    assert spec.limits("all4.static") == {"hdr_max": 1}
    names = [m["name"] for m in spec.metrics("all4.static", True)]
    assert "frames.json_count" in names
    assert "frames.json_count" not in [
        m["name"] for m in spec.metrics("all64.orbit", True)]
    ctx = type("Ctx", (), {"window": [1, 2, 3]})
    assert spec.reader("frames.json_count").read(ctx) == 3
    for p, data in before.items():
        assert p.read_bytes() == data


def test_render_config_makes_tuples():
    cfg = json.loads((HERE / "configs" / "all64.json").read_text())
    r = spec_lib.render_config(cfg)
    assert r["lod_bucket_caps"] == (8, 24, 1 << 30)
    assert r["num_volumes"] == 64 and r["num_volume_srcs"] == 10
