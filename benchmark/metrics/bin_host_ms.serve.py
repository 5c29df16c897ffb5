"""Host ms per served view in the program's own `render.bin` spans
(`bin_gaussians`: tile rects, entries, the depth sort, tile ranges) over the
traced run's profiled sub-window, from `scgaussian_tpu_torch.utils.profiling.WINDOW`."""


def read(ctx):
    if ctx["kind"] != "serve" or "trace" not in ctx:
        return None
    try:
        from scgaussian_tpu_torch.utils.profiling import WINDOW
    except ImportError:
        return None  # a program without spans and counters of its own
    units = WINDOW.units("render.view")
    return WINDOW.total_ms("render.bin") / units if units else None
