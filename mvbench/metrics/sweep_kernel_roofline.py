"""B1, the cube-map march (`csrc/sweep.cu`): its share of its roofline
(%) over the traced frames."""
from mvbench import readers, roofline

WRAPS = [("multivolumes_tpu_torch.render.sweep", "sweep_march")]


def read(ctx):
    return readers.roofline(ctx, "sweep_march", ("sweep_kernel",),
                            roofline.bound_sweep)
