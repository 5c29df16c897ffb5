"""`raster_fwd`'s share of its roofline in the serve cell's sub-window: the
summed least times of its captured launches (`benchmark/lib/yardstick.py`)
over the kernel's device times of the same launches, paired through each
launch's `bench:raster_fwd` span and correlation id (`trace.roofline`)."""

from benchmark.lib import trace


def read(ctx):
    return trace.roofline(ctx, "serve", "raster_fwd", "fwd")
