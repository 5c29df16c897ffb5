"""Tile entries binned per served view: the program's own counter
`bin.entries` over the traced run's profiled sub-window, from
`scgaussian_tpu_torch.utils.profiling.WINDOW`."""


def read(ctx):
    if ctx["kind"] != "serve" or "trace" not in ctx:
        return None
    try:
        from scgaussian_tpu_torch.utils.profiling import WINDOW
    except ImportError:
        return None  # a program without spans and counters of its own
    units = WINDOW.units("render.view")
    return WINDOW.counts.get("bin.entries", 0) / units if units else None
