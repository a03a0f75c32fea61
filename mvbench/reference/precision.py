"""What the reference stores each pass's results in.

The configurations state bf16 sweep stacks (the density and light
stacks the cube-map march reads) and f32 everywhere else. The reference
keeps exactly that (`EXACT`). The control (`LOWER`) is the same
reference one precision step lower, the step a later change would be
tempted to take: fp8 (e4m3) stacks, and every f32 product of a pass
(light maps, cube maps, sky, composite, scene colour, TAA history)
rounded to bf16 where it is stored.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Precision(NamedTuple):
    name: str
    stack: Callable   # a sweep stack (bf16 in the configurations)
    f32: Callable     # an f32 result of a pass


def _round(dtype):
    def rnd(x):
        return x.to(dtype).to(x.dtype)
    return rnd


EXACT = Precision("exact", lambda x: x, lambda x: x)
LOWER = Precision("lower", _round(torch.float8_e4m3fn),
                  _round(torch.bfloat16))
