"""The measurement variants of `tools/kernel_variants.py` still apply to
the kernel sources: every replacement names text that occurs exactly once
in `csrc/sweep.cu`, `csrc/lightsweep.cu`, `csrc/composite.cu`,
`csrc/taa.cu` or `csrc/raster_bin.cu`, and changes it."""

import pytest

from multivolumes_tpu_torch.ops import build
from multivolumes_tpu_torch.tools import kernel_variants as kv

LISTS = {"sweep": ("sweep", kv.SWEEP_VARIANTS),
         "lightsweep": ("lightsweep", kv.SCAN_VARIANTS),
         "advect": ("lightsweep", kv.ADVECT_VARIANTS),
         "composite": ("composite", kv.COMPOSITE_VARIANTS),
         "taa": ("taa", kv.TAA_VARIANTS),
         "raster": ("raster_bin", kv.RASTER_VARIANTS)}
CASES = [(key, name) for key, (_stem, variants) in LISTS.items()
         for name in variants]


@pytest.mark.parametrize("key,name", CASES)
def test_variant_applies_to_the_source(key, name):
    stem, variants = LISTS[key]
    source = (build.CSRC / f"{stem}.cu").read_text()
    edited = kv.apply_edits(source, variants[name])
    assert (edited == source) == (name == "as it is")


def test_a_missing_text_raises():
    with pytest.raises(ValueError, match="occurrences"):
        kv.apply_edits("a b", [("c", "d")])
    with pytest.raises(ValueError, match="occurrences"):
        kv.apply_edits("a a", [("a", "d")])
