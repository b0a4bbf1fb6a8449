"""Profiling: per-stage wall-clock + throughput counters and XLA traces.

reference: the reference's only instrumentation is a Real_Timer around the
searcher cycle (src/searcher_thread.cpp:82-85) plus commented-out timing
hooks (src/searcher.cpp:143,173). Here timing is a first-class utility:

- ``StageTimer`` accumulates wall-clock and item counts per named stage
  (use as a context manager); ``report()`` prints ms/call and items/s.
- ``median_time_s`` and ``compile_and_time`` time device programs: each
  call ends in ``block_until_ready`` (JAX returns before the device
  finishes), compilation is timed apart as set-up, and the steady time
  is the median over repeats.
- ``device_trace`` wraps ``jax.profiler.trace`` so any region can be
  dumped as an XLA/xplane trace for tensorboard (`pip`-free viewing via
  xprof on a capable host).

Example:
    timer = StageTimer()
    with timer("scan", items=len(capbuf)):
        r = xcorr_pss(capbuf, ...)
    print(timer.report())
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class _Stage:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0


@dataclass
class StageTimer:
    stages: Dict[str, _Stage] = field(default_factory=dict)
    sync: Optional[object] = None   # e.g. jax.block_until_ready

    @contextlib.contextmanager
    def __call__(self, name: str, items: float = 0.0, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None and result is not None:
                self.sync(result)
            st = self.stages.setdefault(name, _Stage())
            st.calls += 1
            st.seconds += time.perf_counter() - t0
            st.items += items

    def report(self, unit: str = "items") -> str:
        rows = [f"{'stage':<24} {'calls':>6} {'total s':>9} "
                f"{'ms/call':>9} {unit + '/s':>14}"]
        for name, st in sorted(self.stages.items(),
                               key=lambda kv: -kv[1].seconds):
            rate = st.items / st.seconds if st.seconds and st.items else 0
            rows.append(f"{name:<24} {st.calls:>6} {st.seconds:>9.3f} "
                        f"{1e3 * st.seconds / max(st.calls, 1):>9.2f} "
                        f"{rate:>14,.0f}")
        return "\n".join(rows)

    def reset(self) -> None:
        self.stages.clear()


def median_time_s(fn, reps: int = 10) -> float:
    """Median wall time of ``fn()`` over ``reps`` calls after one warm-up
    call; ``fn`` must end in ``block_until_ready``."""
    import numpy as np

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def memory_dict(compiled) -> dict:
    """``compiled.memory_analysis()`` as plain numbers (bytes)."""
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "peak_memory_in_bytes")
        if hasattr(m, k)}


def compile_and_time(jitted, *args, reps: int = 10, **static) -> dict:
    """Compile ``jitted`` for ``args`` (set-up time), read its
    memory_analysis(), then time the compiled program: median device
    time in ms over ``reps`` calls, each ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    compile_s = time.perf_counter() - t0
    ms = 1e3 * median_time_s(
        lambda: jax.block_until_ready(compiled(*args)), reps)
    return {"compile_s": compile_s, "device_ms": ms,
            "memory": memory_dict(compiled)}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture an XLA profiler (xplane) trace of the enclosed region."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
