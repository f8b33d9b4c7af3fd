"""Host-side spans and Chrome-trace / Perfetto export.

Mirrors ``src/repro/obs/trace.py``.  ``Trace`` records wall-clock
*complete* events ("ph": "X") from the ``span()`` context manager
(Perfetto rebuilds the nesting from the timestamps), counter tracks
("ph": "C") from flushed counters, and instants.  ``to_chrome_trace()``
emits the ``{"traceEvents": [...]}`` JSON that ``chrome://tracing`` and
https://ui.perfetto.dev open; ``from_chrome_trace`` reads it back.

Timestamps are microseconds since the trace epoch (``t0``).  A span times
the host boundary it wraps (an optimizer step call, an evaluation, a
phase): CUDA work is queued asynchronously, so a span around a step that
does not wait for the card measures the host's side of it.  A span adds
no ``torch.cuda.synchronize``; the caller synchronizes where it wants the
device's time inside a span.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Optional


class Trace:
    """An in-memory Chrome-trace event buffer for one run."""

    def __init__(self, run: str = "run", pid: int = 0):
        self.run = run
        self.pid = pid
        self.t0 = time.perf_counter()
        self.events: list[dict] = []
        self._lock = threading.Lock()

    # -- clock --------------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    def _tid(self) -> int:
        return threading.get_ident() % 1_000_000

    def _append(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    # -- recording ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args: Any):
        """Wall-clock region: ``with trace.span("step", step=t): ...``."""
        t0 = self._now_us()
        try:
            yield self
        finally:
            t1 = self._now_us()
            self._append({"name": name, "cat": cat, "ph": "X", "ts": t0,
                          "dur": t1 - t0, "pid": self.pid, "tid": self._tid(),
                          "args": args})

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        self._append({"name": name, "cat": cat, "ph": "i", "s": "g",
                      "ts": self._now_us(), "pid": self.pid,
                      "tid": self._tid(), "args": args})

    def counter(self, name: str, values: dict[str, float],
                ts: Optional[float] = None) -> None:
        """Counter track (one series per dict key)."""
        self._append({"name": name, "cat": "counters", "ph": "C",
                      "ts": self._now_us() if ts is None else ts,
                      "pid": self.pid,
                      "args": {k: float(v) for k, v in values.items()}})

    # -- export -------------------------------------------------------------

    def spans(self) -> list[dict]:
        return [e for e in self.events if e["ph"] == "X"]

    def to_chrome_trace(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"run": self.run, "format": "repro.obs/chrome-trace"},
        }

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    @classmethod
    def from_chrome_trace(cls, payload: dict) -> "Trace":
        """Inverse of :meth:`to_chrome_trace`."""
        other = payload.get("otherData", {})
        t = cls(run=other.get("run", "run"))
        t.events = list(payload["traceEvents"])
        return t

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_chrome_trace(json.load(f))
