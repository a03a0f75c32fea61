"""On the card, the cell `all64.orbit.1440p` (the all64 demo at
2560x1440): a short run of its normal path with the torus is correct
against the reference under the cell's limits; B2' and B5 on a frame's
own operands at 2560x1440 equal their plain versions within the limits
their card tests hold them to at 1280x800 (`PERF.md` section 6); every
host sync of its frames is a sync span. Skips without a card.

    python -m pytest mvbench/tests/test_viewport_card.py -q
"""

import pytest
import torch

from mvbench import harness
from mvbench.spec import Spec

CELL = "all64.orbit.1440p"


@pytest.mark.cuda
def test_short_run_of_the_1440p_cell_is_correct(card):
    r = harness.measure(Spec(), CELL, 2 ** 31 + 19, 2.0, False, card)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0


def _frame_operands(card, monkeypatch, names):
    """The operands of the last call of each entry point `names` ((module,
    name)) in three frames of the cell on the near ladder -> {name: (the
    entry point, args, kwargs less impl)}."""
    captured = {}
    for module, name in names:
        orig = getattr(module, name)

        def call(*a, _orig=orig, _name=name, **k):
            captured[_name] = (_orig, a, {key: v for key, v in k.items()
                                          if key != "impl"})
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, call)
    run = harness.Run(Spec(), CELL, 2 ** 31 + 29, card)
    try:
        run.loop.run(frames=3)
        assert run.engine.config.raster_preset == "near"
        torch.cuda.synchronize()
    finally:
        run.close()
    return captured


@pytest.mark.cuda
def test_b2_depth_at_1440p_matches_plain(card, monkeypatch):
    """B2' (the tile composite with the mesh depth) on a near-ladder
    frame's operands, kernel against plain."""
    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.render import tilecast

    orig, a, k = _frame_operands(card, monkeypatch, [
        (tilecast, "tile_composite")])["tile_composite"]
    assert k["depth_sel"] is not None and a[-2:] == (2560, 1440)
    ops.reset_launches()
    got = orig(*a, **k, impl="kernel")
    assert ops.LAUNCHES["composite_depth"] == 1
    want = orig(*a, **k, impl="plain")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_b5_at_1440p_matches_plain(card, monkeypatch):
    """B5 (the TAA resolve) on a near-ladder frame's operands, after the
    full-screen reprojection, kernel against plain."""
    from multivolumes_tpu_torch.ops import taa as taa_ops

    orig, a, k = _frame_operands(card, monkeypatch, [
        (taa_ops, "taa_resolve")])["taa_resolve"]
    assert tuple(a[0].shape[1:]) == (1440, 2560)
    got = orig(*a, **k, impl="kernel")
    want = orig(*a, **k, impl="plain")
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_every_host_sync_of_the_1440p_frames_is_a_sync_span(card,
                                                           monkeypatch):
    import test_host_syncs_card as syncs

    syncs.test_every_host_sync_is_a_sync_span(card, CELL, monkeypatch)
