"""Profiling utilities — the reference's timing/tracing story.

The reference brackets its frame callback with callgrind macros
(sdf_reconstruction.cpp:26,76-79) and prints per-phase wall-clock times
(camera_tracking.cpp:243, sdf.cpp:306). Equivalents here:

* :class:`Timer` — accumulating wall-clock phase timer (the cout prints,
  structured);
* :func:`device_timer` — context manager that blocks on a pytree before
  stopping the clock, so async dispatch doesn't fake the numbers;
* :func:`trace` — `jax.profiler` trace context (the callgrind wrapper;
  view with xprof/tensorboard).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class Timer:
    """Accumulating phase timer: `with timer("fuse"): ...`; `timer.report()`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def mean_ms(self, phase: str) -> float:
        n = self.counts.get(phase, 0)
        return 1e3 * self.totals[phase] / n if n else 0.0

    def report(self) -> str:
        lines = [
            f"{phase}: {self.mean_ms(phase):.2f} ms/call x{self.counts[phase]} "
            f"(total {self.totals[phase]:.3f} s)"
            for phase in sorted(self.totals)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_timer(timer: Timer, phase: str, result_ref: Optional[list] = None):
    """Like `timer(phase)` but blocks on the result pytree first.

    Usage:
        out = []
        with device_timer(timer, "fuse", out):
            out.append(fuse(...))
    """
    import jax

    t0 = time.perf_counter()
    try:
        yield
    finally:
        if result_ref:
            jax.block_until_ready(result_ref[-1])
        timer.totals[phase] += time.perf_counter() - t0
        timer.counts[phase] += 1


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context — xprof-viewable device timeline."""
    import jax

    with jax.profiler.trace(log_dir):
        yield
