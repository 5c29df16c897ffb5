"""`raster_bwd`'s share of its roofline in the train cell's sub-window: the
summed least times of its captured launches (`benchmark/lib/yardstick.py`)
over the kernel's device times of the same launches, paired through each
launch's `bench:raster_bwd` span and correlation id (`trace.roofline`)."""

from benchmark.lib import trace


def read(ctx):
    return trace.roofline(ctx, "train", "raster_bwd", "bwd")
