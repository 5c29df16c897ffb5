"""A time limit for each of the port's tests: every `tests/test_torch_*.py`
imports the autouse fixture `per_test_limit`, and a test still running after
`TEST_LIMIT` seconds fails with TimeoutError where it stands, with its
traceback, instead of holding its worker until the whole suite's limit.

The alarm reaches Python-level waits (`join`, `communicate`, `recv`,
`sleep`); every wait in the port's tests has a timeout of its own below the
limit, so its own cleanup runs first. No JAX here: `test_torch_parallel.py`
imports this module, and its spawned ranks import that file."""

import contextlib
import signal

import pytest

# About three times the slowest port test beside five other xdist workers on
# 8 cores (test_run_main_stage_matches_jax, 43-70 s). The longest wait inside
# a port test, a rank join or a subprocess, is 120 s.
TEST_LIMIT = 240


@contextlib.contextmanager
def time_limit(seconds):
    """Raise TimeoutError in the main thread once `seconds` have passed."""

    def expire(signum, frame):
        raise TimeoutError(f"ran past its limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def per_test_limit():
    with time_limit(TEST_LIMIT):
        yield
