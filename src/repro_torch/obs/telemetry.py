"""The user-facing telemetry facade.

Mirrors ``src/repro/obs/telemetry.py``.  One ``Telemetry`` object per run
ties the layers together:

* **spans / trace** -- a host-side :class:`~repro_torch.obs.trace.Trace`
  whose Chrome-trace JSON lands under ``out_dir`` at :meth:`export`;
* **counters** -- :meth:`init_counters` seeds the counter leaf
  (:class:`~repro_torch.obs.wire.Counters`) and :meth:`flush_counters`
  writes it to the event log every ``flush_every`` steps;
* **event log** -- every flush / dashboard / export appends a
  schema-validated line to ``<out_dir>/<run>.events.jsonl``.

The JAX package flushes from inside a jitted step through an
``io_callback``, and its ``make_obs_step`` compiles two executables (a
quiet one and a flushing one, chosen per call through ``flush_mode``) so
that ordinary steps keep fast dispatch.  The port runs eagerly: it has no
callback and no executables to choose between, so neither ``flush_mode``
nor ``make_obs_step`` has a counterpart.  Every optimizer step calls
:meth:`flush_counters` with its Python-int step, and the counters are
flushed when ``step % flush_every == 0``, the cadence of the JAX
package's own step; only a flushing step reads the counters' drawn terms
back from the card.

The optimizers take ``telemetry=None`` by default, and then thread no
counters and flush nothing.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from repro_torch.obs import events as obs_events
from repro_torch.obs import wire as obs_wire
from repro_torch.obs.trace import Trace


@dataclasses.dataclass
class Telemetry:
    """Per-run telemetry configuration and host-side sinks."""

    run: str = "run"
    out_dir: str = os.path.join("experiments", "telemetry")
    flush_every: int = 50          # counter flush cadence, in optimizer steps
    trace: Trace = None            # created in __post_init__ when omitted

    def __post_init__(self):
        if self.trace is None:
            self.trace = Trace(run=self.run)
        self._meta_written = False

    # -- paths --------------------------------------------------------------

    @property
    def events_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.run}.events.jsonl")

    @property
    def trace_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.run}.trace.json")

    # -- host-side event emission -------------------------------------------

    def event(self, type_: str, data: dict, step: Optional[int] = None) -> dict:
        self._ensure_meta()
        ev = obs_events.make_event(type_, self.run, data, step=step)
        obs_events.append_jsonl(self.events_path, ev)
        return ev

    def _ensure_meta(self) -> None:
        if self._meta_written:
            return
        self._meta_written = True
        cuda = torch.cuda.is_available()
        ev = obs_events.make_event(
            "meta", self.run,
            {"backend": "cuda" if cuda else "cpu",
             "device_count": torch.cuda.device_count() if cuda else 1,
             "flush_every": self.flush_every,
             "started": time.strftime("%Y-%m-%dT%H:%M:%S")})
        obs_events.append_jsonl(self.events_path, ev)

    def span(self, name: str, **args):
        return self.trace.span(name, **args)

    # -- counters -----------------------------------------------------------

    def init_counters(self, device="cpu") -> obs_wire.Counters:
        """Zero counters, the drawn terms on ``device`` (the state's)."""
        return obs_wire.zero_counters(device)

    def flush_counters(self, counters: obs_wire.Counters, step: int) -> None:
        """Write ``counters`` to the event log and the trace when ``step``
        is a multiple of ``flush_every``; otherwise touch nothing."""
        if step % self.flush_every != 0:
            return
        data = obs_wire.unpack(counters).as_dict()
        self.event("counters", data, step=int(step))
        self.trace.counter("wire", {"wire_bytes": data["wire_bytes"],
                                    "raw_bytes": data["raw_bytes"],
                                    "hops": data["hops"]})

    # -- convergence dashboard ----------------------------------------------

    def dashboard(self, problem, x_stacked, y_stacked, batches, step: int,
                  extra: Optional[dict] = None) -> dict:
        """Stream M_t components, per-geometry feasibility and cross-node
        drift into the event log (host-side, at the caller's cadence)."""
        from repro_torch.core import metric as core_metric  # no import cycle

        m = core_metric.convergence_metric(problem, x_stacked, y_stacked,
                                           batches)
        data = {k: float(v) for k, v in m.items()}
        data["drift"] = {
            name: float(v)
            for name, v in core_metric.per_leaf_drift(
                problem, x_stacked).items()}
        if extra:
            data.update(extra)
        return self.event("dashboard", data, step=step)

    # -- export -------------------------------------------------------------

    def export(self) -> dict:
        """Write the Perfetto/Chrome trace; returns the artifact paths."""
        self._ensure_meta()
        path = self.trace.save(self.trace_path)
        return {"trace": path, "events": self.events_path}


def read_counter_series(events_path: str) -> list[dict]:
    """The flushed counter events of a run, in step order."""
    rows = [ev for ev in obs_events.read_jsonl(events_path)
            if ev["type"] == "counters"]
    rows.sort(key=lambda ev: ev.get("step", 0))
    return rows


def latest_dashboard(events_path: str) -> Optional[dict]:
    rows = [ev for ev in obs_events.read_jsonl(events_path)
            if ev["type"] == "dashboard"]
    return max(rows, key=lambda ev: ev.get("step", 0)) if rows else None


def summarize_run(events_path: str) -> dict:
    """Compact JSON summary of one event log."""
    counters = read_counter_series(events_path)
    dash = latest_dashboard(events_path)
    out: dict = {"n_events": obs_events.validate_log(events_path)}
    if counters:
        last = counters[-1]
        out["counters"] = last["data"]
        out["counters_step"] = last.get("step")
        hops = max(last["data"].get("hops", 0), 1)
        out["bytes_per_hop"] = last["data"].get("wire_bytes", 0.0) / hops
    if dash:
        out["dashboard"] = dash["data"]
        out["dashboard_step"] = dash.get("step")
    return out
