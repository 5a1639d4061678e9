"""Minimal tracing: COLORID_TRACE=1 prints per-span wall times to stderr.

The reference's only observability is ad-hoc eprintln! timing around index
load and search (SURVEY §5); this makes every pipeline stage measurable
without a profiler.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_ENABLED = os.environ.get("COLORID_TRACE", "") not in ("", "0")


def enabled() -> bool:
    return _ENABLED


@contextmanager
def span(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        print(f"[trace] {name}: {time.time() - t0:.3f}s", file=sys.stderr)
