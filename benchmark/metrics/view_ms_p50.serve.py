"""The median latency of every view served in the window, in ms: steadier
than the 95th percentile beside it."""

from benchmark.lib.harness import percentile


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["latencies"]:
        return None
    return percentile(ctx["latencies"], 50) * 1e3
