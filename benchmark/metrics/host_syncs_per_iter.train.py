"""Host syncs per main-stage iteration: the program's own counter
`host_syncs` (each place its hot path makes the host wait for the device)
over the traced run's profiled sub-window, from
`scgaussian_tpu_torch.utils.profiling.WINDOW`."""


def read(ctx):
    if ctx["kind"] != "train" or "trace" not in ctx:
        return None
    try:
        from scgaussian_tpu_torch.utils.profiling import WINDOW
    except ImportError:
        return None  # a program without spans and counters of its own
    units = WINDOW.units("train.step")
    return WINDOW.counts.get("host_syncs", 0) / units if units else None
