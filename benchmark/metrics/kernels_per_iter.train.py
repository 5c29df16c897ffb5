"""Device kernels the profiler counts over the sub-window per main-stage iteration."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or not t or not ctx.get("units"):
        return None
    return t["launches"] / ctx["units"]
