"""On the card: one short run of a real cell is correct and names the
card. Skips without one."""

import pytest

from mvbench import harness
from mvbench.spec import Spec


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    r = harness.measure(Spec(), "all16.orbit.nomesh", 7, 2.0, False, card)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"]["fps"]["value"] > 0.0
