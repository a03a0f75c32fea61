"""Host ms a frame spent inside `MultiRayCaster.render`, the mean over
all the window's frames (the harness's clock around the call)."""


def read(ctx):
    if not ctx.window:
        return None
    return 1e3 * sum(f.dispatch_s for f in ctx.window) / len(ctx.window)
