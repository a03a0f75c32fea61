"""B3 (B3' with the mesh's shadow), the light self scan
(`csrc/lightsweep.cu`): its share of its roofline (%) over the traced
frames."""
from mvbench import readers, roofline

WRAPS = [("multivolumes_tpu_torch.ops.lightsweep", "light_self_scan")]


def read(ctx):
    return readers.roofline(ctx, "light_self_scan", ("self_scan_kernel",),
                            roofline.bound_self_scan)
