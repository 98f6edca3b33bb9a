"""Tracing / profiling helpers.

The reference has no tracing beyond a wall-clock progress line
(src/Mapping.cpp:509) and indexer phase timers (src/BWT_Index/
bwtindex.c:93-145).  This module adds device-era equivalents:

  * StageTimers — lightweight named accumulators for the host pipeline
    stages (read / seed / post / emit), printed as a per-read breakdown;
  * device_trace — context manager around jax.profiler for capturing a
    device trace viewable in TensorBoard/Perfetto (KART_TRACE_DIR or arg);
  * progress_line — the reference's \\r-rewritten progress reporter.

Enable stage timing with KART_TIMERS=1; the native pipeline's own
per-stage profile is KART_PROF=1 (kart_post.cpp).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict


class StageTimers:
    """Named wall-clock accumulators: with timers.stage("seed"): ..."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = (
            enabled if enabled is not None else os.environ.get("KART_TIMERS") == "1"
        )
        self.acc: dict[str, float] = defaultdict(float)
        self.n: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.n[name] += 1

    def report(self, n_items: int | None = None, file=sys.stderr) -> None:
        if not self.enabled or not self.acc:
            return
        parts = []
        for k in sorted(self.acc, key=self.acc.get, reverse=True):
            line = f"{k}={self.acc[k]:.3f}s"
            if n_items:
                line += f" ({1e9 * self.acc[k] / n_items:.0f}ns/item)"
            parts.append(line)
        print("[kart_timers] " + "  ".join(parts), file=file)


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Capture a jax device trace (jax.profiler) for the enclosed block.  No-op
    unless a directory is given or KART_TRACE_DIR is set."""
    trace_dir = trace_dir or os.environ.get("KART_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def progress_line(total: int, kind: str, t0: float, file=sys.stdout) -> None:
    """The reference's progress reporter (Mapping.cpp:509)."""
    print(
        f"\r{total} {kind} reads have been processed in {int(time.time() - t0)} seconds...",
        end="",
        flush=True,
        file=file,
    )
