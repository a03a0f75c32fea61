"""Millions of pixels the mesh's deferred shade covers a frame in the
measured window: the program's counter `mesh.shade_px`, its window under
the far preset where the window contains the mesh, else the screen."""
from mvbench import counters


def read(ctx):
    v = counters.mean(ctx, "mesh.shade_px")
    return None if v is None else v / 1e6
