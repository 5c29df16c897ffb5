"""Process start to the first timed iteration or view, in seconds."""


def read(ctx):
    return ctx["setup_s"]
