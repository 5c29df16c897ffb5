"""Views completed in the window over the window's wall time."""

from benchmark.lib.harness import rate


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["views"]:
        return None
    return rate(ctx["views"], ctx["window_s"])
