"""The 95th percentile of the latency of every view served in the window, in ms."""

from benchmark.lib.harness import percentile


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["latencies"]:
        return None
    return percentile(ctx["latencies"], 95) * 1e3
