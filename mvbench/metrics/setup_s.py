"""Process start to the first timed frame: imports, the kernel library,
the scene, densities, torus, shadow map, light refreshes, warm-up."""


def read(ctx):
    return ctx.setup_s
