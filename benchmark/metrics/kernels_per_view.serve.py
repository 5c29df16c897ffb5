"""Device kernels the profiler counts over the sub-window per served view."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "serve" or not t or not ctx.get("units"):
        return None
    return t["launches"] / ctx["units"]
