"""Profiling / diagnostics (SURVEY.md §5 "tracing": the reference prints
ad-hoc wall-clock per pipeline stage, deepVCP.py:28-98; here the same
capability is structured — named stage scopes for jax.profiler traces plus
a per-stage latency report — with proper device synchronization).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

import jax


class StageTimer:
    """Wall-clock per-stage latency report.

    Each stage blocks on its outputs, so the numbers are true device
    latencies. Usage:

        timer = StageTimer()
        with timer.stage("fe"):
            feats = fe(...)
        ...
        print(timer.report())
    """

    def __init__(self):
        self.times: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.times.append((name, time.perf_counter() - t0))

    def timeit(self, name: str, fn: Callable, *args, **kwargs):
        """Run fn, block on its result, record the latency, return it."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.times.append((name, time.perf_counter() - t0))
        return out

    def report(self) -> str:
        total = sum(t for _, t in self.times)
        lines = [f"{'stage':24s} {'ms':>10s} {'%':>6s}"]
        for name, t in self.times:
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:24s} {t * 1e3:10.2f} {pct:6.1f}")
        lines.append(f"{'total':24s} {total * 1e3:10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return {name: t for name, t in self.times}


def annotate(name: str):
    """Named scope that shows up in jax.profiler traces
    (jax.profiler.TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


def trace(log_dir: str):
    """Context manager: capture a jax.profiler device trace into log_dir
    (viewable in TensorBoard / Perfetto)."""
    return jax.profiler.trace(log_dir)


def enable_nan_checks(enable: bool = True) -> None:
    """Global NaN debugging (SURVEY.md §5 "race detection/sanitizers": XLA
    is value-semantics; NaN checks are the relevant sanitizer)."""
    jax.config.update("jax_debug_nans", enable)
