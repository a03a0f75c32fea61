"""B2 (B2' with the mesh), the tile OIT composite (`csrc/composite.cu`):
its share of its roofline (%) over the traced frames."""
from mvbench import readers, roofline

WRAPS = [("multivolumes_tpu_torch.render.tilecast", "tile_composite")]


def read(ctx):
    return readers.roofline(
        ctx, "tile_composite", ("tile_composite_kernel", "mesh_tile_kernel"),
        roofline.bound_composite)
