"""The measurement variants of `tools/kernel_variants.py` still apply to
the kernel sources: every replacement names text that occurs exactly once
in `csrc/sweep.cu` or `csrc/lightsweep.cu`, and changes it."""

import pytest

from multivolumes_tpu_torch.ops import build
from multivolumes_tpu_torch.tools import kernel_variants as kv

CASES = [("sweep", name) for name in kv.SWEEP_VARIANTS] \
    + [("lightsweep", name) for name in kv.SCAN_VARIANTS]


@pytest.mark.parametrize("stem,name", CASES)
def test_variant_applies_to_the_source(stem, name):
    variants = kv.SWEEP_VARIANTS if stem == "sweep" else kv.SCAN_VARIANTS
    source = (build.CSRC / f"{stem}.cu").read_text()
    edited = kv.apply_edits(source, variants[name])
    assert (edited == source) == (name == "as it is")


def test_a_missing_text_raises():
    with pytest.raises(ValueError, match="occurrences"):
        kv.apply_edits("a b", [("c", "d")])
    with pytest.raises(ValueError, match="occurrences"):
        kv.apply_edits("a a", [("a", "d")])
