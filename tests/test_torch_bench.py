"""The port's bench (`multivolumes_tpu_torch/bench.py`) against the JAX
package's (`bench.py`) on the CPU: its configs, read from `bench.py` with
`ast` (no import: a change to the JAX bench fails here), its CLI and its
last line, and its frames against the JAX frames on the bench's own
scene and camera sequence at the small config (golden-image limits:
mean < 2e-3, p99.9 < 3e-2, tests/test_goldens.py:37-41), with its two
dispatch modes within atol 2e-5 of each other."""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import (clone_state, image_stats,  # noqa: F401
                          jax_state_dict, one_torch_thread, port_config)

from multivolumes_tpu.config import RenderConfig as JaxRenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.engine import MultiRayCaster as JaxEngine
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu_torch import bench
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.scene import state as pstate

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KEYS = {"metric", "value", "unit", "vs_baseline", "mode"}


def _jax_bench():
    """From the JAX bench's source: ({on_tpu: (RenderConfig keywords,
    frames)}, `_BUNNY`)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    bunny = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "_BUNNY")
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")

    def config_call(stmts):
        return next(n for s in stmts for n in ast.walk(s)
                    if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "RenderConfig")

    branch = next(n for n in ast.walk(main) if isinstance(n, ast.If)
                  and getattr(n.test, "id", None) == "on_tpu"
                  and any(isinstance(c, ast.Call)
                          and getattr(c.func, "id", None) == "RenderConfig"
                          for s in n.body for c in ast.walk(s)))
    out = {}
    for on_tpu, stmts in ((True, branch.body), (False, branch.orelse)):
        kw = {k.arg: ast.literal_eval(k.value)
              for k in config_call(stmts).keywords}
        frames = next(ast.literal_eval(s.value) for s in stmts
                      if isinstance(s, ast.Assign)
                      and getattr(s.targets[0], "id", None) == "frames")
        out[on_tpu] = (kw, frames)
    return out, bunny


@pytest.mark.parametrize("on_card", [True, False])
def test_configs_are_the_jax_bench_configs(on_card):
    configs, bunny = _jax_bench()
    kw, frames = configs[on_card]
    cfg, got_frames = bench.bench_config(on_card)
    assert cfg == port_config(JaxRenderConfig(**kw))
    assert got_frames == frames
    assert bench.BUNNY == bunny


def test_cli_on_the_cpu_prints_the_jax_bench_record(capsys):
    assert bench.main(["--cpu"]) == 0
    out, err = capsys.readouterr()
    record = json.loads(out.strip().splitlines()[-1])
    assert set(record) == KEYS
    assert record["metric"] == "frame_fps_small_cpu"
    assert record["unit"] == "frames/s"
    assert record["value"] > 0
    # both are rounded from the same fps: value to 3 places, vs_baseline
    # to 4, so they agree within the two roundings
    assert abs(record["vs_baseline"] - record["value"] / 60) \
        <= 0.5e-4 + 0.5e-3 / 60
    assert record["mode"] in {"scan", "async"}
    assert "amortized: scan x1 " in err
    assert "per-frame(ms, 4-frame batches): " in err
    assert "readback(ms): " in err
    assert "\np50 " in "\n" + err
    # the breakdown runs on the card only, as the JAX bench's on the TPU
    assert "passes(ms):" not in err


def test_cli_stops_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        bench.main([])


@pytest.fixture(scope="module")
def jax_case():
    """The JAX bench's scene at the small config and its first three
    frames: the warm-up step at t = 0, the warm-up block (K = 1: t = 0)
    and the first timed block (t = 1/60)."""
    kw, _frames = _jax_bench()[0][False]
    engine = JaxEngine(JaxRenderConfig(**kw))
    cfg = engine.config
    step = jax.jit(lambda s, c: jframe.render_frame(
        s, c, cfg, use_taa=True, planar=True))
    state = engine.state
    start = jax_state_dict(state)
    images = []
    for t in (0.0, 0.0, 1.0 / 60.0):
        out = step(state, jcam.orbit_camera(t, cfg.aspect_ratio))
        images.append(np.asarray(out.image))
        state = out.state
    return cfg, start, images


def test_bench_frames_match_jax(jax_case):
    jcfg, start, jimgs = jax_case
    cfg, _frames = bench.bench_config(False)
    engine = MultiRayCaster(cfg, CPU)
    assert engine.config == port_config(jcfg)
    cfg = engine.config
    state = pstate.state_from_numpy(start)
    img, state = bench.step(
        state, pcam.orbit_camera(0.0, cfg.aspect_ratio, device=CPU), cfg)
    images = [img]
    for f0 in (-1, 0):
        imgs, state = bench.scan(
            state, bench.orbit_cameras(f0, 1, cfg, CPU), cfg)
        images.append(imgs[0])
    assert state.frame_idx == 3
    for f, (got, want) in enumerate(zip(images, jimgs)):
        assert tuple(got.shape) == (3, cfg.height, cfg.width)
        mean, p999, mx = image_stats(got, want, 99.9)
        assert mean < 2e-3 and p999 < 3e-2, (f, mean, p999, mx)


def test_scan_and_async_modes_render_the_same_frames(jax_case):
    _jcfg, start, _ = jax_case
    cfg = MultiRayCaster(bench.bench_config(False)[0], CPU).config
    cams = bench.orbit_cameras(0, 3, cfg, CPU)
    state = pstate.state_from_numpy(start)
    block, s_scan = bench.scan(clone_state(state), cams, cfg)
    for f, cam in enumerate(cams):
        img, state = bench.step(state, cam, cfg)
        torch.testing.assert_close(block[f], img, atol=2e-5, rtol=0)
    assert s_scan.frame_idx == state.frame_idx == 3
    torch.testing.assert_close(s_scan.taa_history, state.taa_history,
                               atol=2e-5, rtol=0)
