"""The port tests' time limit (`tests/time_limits.py`): the alarm fails a test
that overruns, with its traceback, and leaves no timer armed after it."""

import os
import signal
import subprocess
import sys
import textwrap
import time

from time_limits import time_limit

TESTS = os.path.dirname(os.path.abspath(__file__))


def test_time_limit_raises_and_cancels_the_alarm():
    handler = signal.getsignal(signal.SIGALRM)
    start = time.monotonic()
    try:
        with time_limit(1):
            time.sleep(5)
    except TimeoutError:
        took = time.monotonic() - start
    else:
        raise AssertionError("no TimeoutError")
    assert took < 2, took
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) is handler
    with time_limit(1):  # a body that ends in time leaves no alarm armed
        pass
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) is handler


def test_per_test_limit_fails_the_test_that_overruns(tmp_path):
    (tmp_path / "test_overrun.py").write_text(textwrap.dedent("""
        import time

        import time_limits
        from time_limits import per_test_limit  # noqa: F401

        time_limits.TEST_LIMIT = 1

        def test_waits_too_long():
            time.sleep(30)

        def test_after():
            pass
    """))
    start = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", str(tmp_path)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=TESTS),
        capture_output=True, text=True, timeout=120,
    )
    took = time.monotonic() - start
    out = res.stdout + res.stderr
    assert res.returncode == 1, out
    assert "TimeoutError: ran past its limit of 1 s" in out, out
    assert "time.sleep(30)" in out, out  # the traceback shows where it stood
    assert "1 failed, 1 passed" in res.stdout, out
    assert took < 25, (took, out)
