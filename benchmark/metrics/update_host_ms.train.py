"""Host ms per main-stage iteration in the program's own `step.stats`
(`update_stats`) and `step.adam` (`apply_update`) spans over the traced
run's profiled sub-window, from `scgaussian_tpu_torch.utils.profiling.WINDOW`."""


def read(ctx):
    if ctx["kind"] != "train" or "trace" not in ctx:
        return None
    try:
        from scgaussian_tpu_torch.utils.profiling import WINDOW
    except ImportError:
        return None  # a program without spans and counters of its own
    units = WINDOW.units("train.step")
    return WINDOW.total_ms("step.stats", "step.adam") / units if units else None
