"""Device profiling and robust throughput measurement.

The reference has no profiling subsystem (SURVEY.md section 5); this
framework provides jax.profiler trace capture plus a drift-robust
throughput measurement: per-call wall clock carries fixed dispatch and
synchronization latency, so throughput is estimated from the SLOPE of
total time vs pipelined iteration count (the intercept absorbs latency).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def throughput(fn, args, items_per_call: int, iters=(4, 32), trials: int = 2):
    """items/sec via iteration-count slope; returns (best_rate, details).

    fn must be an async-dispatching jitted callable; the result is blocked
    once per iteration group.
    """
    import jax

    jax.block_until_ready(fn(*args))  # warmup / compile
    rates = []
    for _ in range(trials):
        pts = []
        for it in iters:
            t0 = time.perf_counter()
            out = None
            for _ in range(it):
                out = fn(*args)
            jax.block_until_ready(out)
            pts.append((it, time.perf_counter() - t0))
        (i1, t1), (i2, t2) = pts[0], pts[-1]
        per_call = (t2 - t1) / (i2 - i1)
        if per_call > 0:
            rates.append(items_per_call / per_call)
    best = max(rates) if rates else 0.0
    return best, {"rates": rates}
