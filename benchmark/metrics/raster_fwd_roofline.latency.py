"""`raster_fwd_roofline.serve`'s reading, in the serve cells that report `view_ms_p95`
(the metric it moves there) instead of `views_per_s`."""

from benchmark.lib import harness


def read(ctx):
    return harness.reader("raster_fwd_roofline.serve")(ctx)
