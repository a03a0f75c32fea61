"""B4, the light advect-multiply (`csrc/lightsweep.cu`): its share of
its roofline (%) over the traced frames."""
from mvbench import readers, roofline

WRAPS = [("multivolumes_tpu_torch.ops.lightsweep", "light_advect_mul")]


def read(ctx):
    return readers.roofline(ctx, "light_advect_mul", ("self_scan_kernel",),
                            roofline.bound_advect)
