"""Profiling / tracing hooks (reference: gettimeofday pairs + CSV,
test_spmv.c:89-127; here: jax.profiler traces + the same metrics).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

__all__ = ["trace", "Stopwatch", "predeal_profile", "dev_put"]


#: active predeal profile record (None = profiling off, zero overhead)
_PREDEAL_LAPS: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def predeal_profile():
    """Record handle creation's host-pack vs device-transfer split.

    Yields a dict updated in place: ``transfer_s`` (wall seconds spent in
    blocked device transfers) and ``bytes`` (plan bytes shipped).  Pack
    time is the caller's total predeal minus ``transfer_s``.  Each
    transfer is blocked on inside the context so the split is honest —
    this serializes transfers against host pack work, so use it for
    measurement sweeps, not hot paths.  The reference's predeal column
    has no such split (test_spmv.c:89-93); it separates host contention
    from real pack cost."""
    global _PREDEAL_LAPS
    prev = _PREDEAL_LAPS
    _PREDEAL_LAPS = {"transfer_s": 0.0, "bytes": 0}
    try:
        yield _PREDEAL_LAPS
    finally:
        _PREDEAL_LAPS = prev


def dev_put(x):
    """jax.device_put, instrumented when a predeal_profile is active."""
    import jax
    if _PREDEAL_LAPS is None:
        return jax.device_put(x)
    t0 = time.perf_counter()
    r = jax.block_until_ready(jax.device_put(x))
    _PREDEAL_LAPS["transfer_s"] += time.perf_counter() - t0
    _PREDEAL_LAPS["bytes"] += getattr(r, "nbytes", 0)
    return r


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto.

    On a GPU the trace holds the device's kernel events beside the host's.
    """
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Stopwatch:
    """Reference-style paired wall timers (test_spmv.c:89-124)."""

    def __init__(self):
        self.laps = {}

    @contextlib.contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.laps[name] = self.laps.get(name, 0.0) + \
                (time.perf_counter() - t0)

    def report(self) -> str:
        return ", ".join(f"{k}={v*1e3:.2f}ms" for k, v in self.laps.items())
