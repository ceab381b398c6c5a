"""Tracing / profiling helpers.

The reference's only observability is three couts and a printf kernel
(SURVEY §5).  Here: jax.profiler traces plus named scopes around the engine
phases (flux / reciprocal / direct / chain rule) so per-phase cost shows up
in the profiler's trace, and a host-side step timer that respects async
dispatch.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def phase_scope(name: str):
    """Named scope visible in profiler traces (jax.named_scope)."""
    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace around a block of work."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class step_timer:
    """Wall-clock timer that waits for a pytree of outputs.

    Dispatch is asynchronous, so the timed block must end in a wait for
    its results:

        with step_timer() as t:
            out = step(...)
            t.sync(out)
        print(t.elapsed)
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, out):
        return jax.block_until_ready(out)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
