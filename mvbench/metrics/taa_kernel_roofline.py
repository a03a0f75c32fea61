"""B5, the TAA resolve (`csrc/taa.cu`): its share of its roofline (%)
over the traced frames."""
from mvbench import readers, roofline

WRAPS = [("multivolumes_tpu_torch.ops.taa", "taa_resolve")]


def read(ctx):
    return readers.roofline(ctx, "taa_resolve", ("taa_resolve_kernel",),
                            roofline.bound_taa)
