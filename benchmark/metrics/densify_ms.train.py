"""Synchronised host ms per `densify_and_prune` event in the traced run's
window (none: nothing to read)."""


def read(ctx):
    s = ctx.get("densify_s") or []
    return 1e3 * sum(s) / len(s) if s else None
