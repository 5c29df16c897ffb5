"""Synchronised host seconds of the program's `setup_from_matches` call
(kNN, init stage, promotion, `create_model`)."""


def read(ctx):
    return ctx.get("from_matches_s")
