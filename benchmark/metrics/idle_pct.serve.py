"""The device's idle share over the profiled sub-window of the serve cell:
100 x (1 - busy time / wall time), busy the union of the device's activity."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "serve" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
