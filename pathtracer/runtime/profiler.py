"""Profiling: wall-clock buckets + optional XLA trace capture.

The reference keeps three std::chrono accumulators (state/render/display)
shown by sutil::displayStats (reference optixSphere.cpp:1386-1431).  Here:
named wall-clock buckets with the same spirit, plus `jax.profiler` trace
capture for TensorBoard when deep kernel-level data is wanted
(SURVEY.md §5 tracing rebuild note)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class FrameStats:
    """Accumulating wall-clock buckets (state/render/display analog)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def bucket(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        parts = []
        for name in sorted(self.totals):
            n = max(self.counts[name], 1)
            parts.append(f"{name}: {self.totals[name]/n*1e3:.2f} ms/it (x{n})")
        return " | ".join(parts)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def xla_trace(logdir: str) -> Iterator[None]:
    """Capture an XLA device trace viewable in TensorBoard (--profile flag)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
