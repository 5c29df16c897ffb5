"""Main-stage iterations completed in the window over the window's wall time."""

from benchmark.lib.harness import rate


def read(ctx):
    if ctx["kind"] != "train" or not ctx["iterations"]:
        return None
    return rate(ctx["iterations"], ctx["window_s"])
