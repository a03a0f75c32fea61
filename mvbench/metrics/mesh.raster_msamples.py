"""Millions of coverage samples the mesh raster launches a frame in the
measured window: the program's counter `mesh.raster_samples`, each emit's
triangles x its grid plus the dense pass's triangles x the pixels it
z-tests, worked out on the host from the frame's tier ladder."""
from mvbench import counters


def read(ctx):
    v = counters.mean(ctx, "mesh.raster_samples")
    return None if v is None else v / 1e6
