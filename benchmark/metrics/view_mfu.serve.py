"""The whole view's share of the card's fp32 peak: the sub-window's counted
operations (the pairs that change a pixel, per-Gaussian projection) over
its wall time x 67 TFLOP/s."""

from benchmark.lib import yardstick


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("launches")
    if ctx["kind"] != "serve" or not t or not w or not w["flops"]:
        return None
    return 100.0 * w["flops"] / (t["window_s"] * yardstick.H100_FP32_OPS_PER_S)
