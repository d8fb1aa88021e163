"""Per-query device profiler capture (the port of
presto_tpu/telemetry/profiler.py on torch.profiler).

The `profile` session property wraps ONE query's execution in a
torch.profiler capture (the CPU and, on the card, CUDA activities) and
writes it as a Chrome trace (`trace.json`) into a per-query directory:
the device-level twin of EXPLAIN ANALYZE -- operator stats say where the
rows went, the trace says what the card did.

Profiling is best-effort: a profiler failure (a capture already running
in this process, a read-only profile directory) never fails the query;
the capture yields None and the query runs unprofiled.
"""
from __future__ import annotations

import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

# one capture at a time per process: a query that loses the race runs
# unprofiled rather than queueing behind another query's capture
_capture_lock = threading.Lock()

TRACE_FILE = "trace.json"


def _safe_dirname(query_id: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", query_id) or "query"


@contextmanager
def profile_capture(profile_dir: Optional[str],
                    query_id: str,
                    enabled: bool = True,
                    clock=time.time) -> Iterator[Optional[str]]:
    """Yield the per-query trace directory being captured, or None when
    capture is disabled or unavailable.  The yielded path is what the
    EXPLAIN ANALYZE footer reports; the trace file lands in it when the
    block exits."""
    if not enabled or not profile_dir:
        yield None
        return
    if not _capture_lock.acquire(blocking=False):
        yield None
        return
    trace_dir = os.path.join(
        profile_dir, f"{_safe_dirname(query_id)}-{int(clock() * 1000)}")
    prof = None
    try:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception:
            prof = None
        yield trace_dir if prof is not None else None
    finally:
        if prof is not None:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(trace_dir,
                                                      TRACE_FILE))
            except Exception:
                pass
        _capture_lock.release()
