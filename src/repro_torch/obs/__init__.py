"""repro_torch.obs -- telemetry: spans and traces, wire and kernel counters,
and the convergence dashboard (``src/repro/obs/`` of the JAX package).

* :mod:`repro_torch.obs.trace` -- host-side spans, Chrome-trace/Perfetto
  export;
* :mod:`repro_torch.obs.wire` + :mod:`repro_torch.obs.estimates` -- wire
  counters threaded through the optimizer state and analytical per-kernel
  cost estimates;
* :mod:`repro_torch.obs.telemetry` -- the ``Telemetry`` facade the
  optimizers, the serving engine and ``launch/obs.py`` take, flushing to
  the schema-validated JSONL event log (:mod:`repro_torch.obs.events`).

This package never imports ``repro_torch.core`` or ``repro_torch.kernels``
at module scope (the dependency points the other way).
"""
from repro_torch.obs import estimates, events, trace, wire  # noqa: F401
from repro_torch.obs.estimates import Estimates  # noqa: F401
from repro_torch.obs.telemetry import Telemetry  # noqa: F401
from repro_torch.obs.trace import Trace  # noqa: F401
from repro_torch.obs.wire import (WireCounters, unpack, wrap_mixer,  # noqa: F401
                                  zero_counters)
