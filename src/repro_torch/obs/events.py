"""Append-only JSONL event log, validated against a schema.

Mirrors ``src/repro/obs/events.py``.  Every telemetry record has one shape
(``event_schema.json`` next to this module, a byte-equal copy of the JAX
package's): ``{type, ts, run, data[, step]}``.  The validator implements
the JSON-Schema subset that schema uses (type / required / properties /
enum / additionalProperties), so validation needs no third-party package.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator, Optional

SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "event_schema.json")

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
}


def load_schema() -> dict:
    with open(SCHEMA_PATH) as f:
        return json.load(f)


_SCHEMA_CACHE: Optional[dict] = None


def schema() -> dict:
    global _SCHEMA_CACHE
    if _SCHEMA_CACHE is None:
        _SCHEMA_CACHE = load_schema()
    return _SCHEMA_CACHE


def _check(value: Any, spec: dict, path: str) -> None:
    t = spec.get("type")
    if t == "number":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{path}: expected number, got "
                             f"{type(value).__name__}")
    elif t == "integer":
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"{path}: expected integer, got "
                             f"{type(value).__name__}")
    elif t in _TYPES:
        if not isinstance(value, _TYPES[t]):
            raise ValueError(f"{path}: expected {t}, got "
                             f"{type(value).__name__}")
    if "enum" in spec and value not in spec["enum"]:
        raise ValueError(f"{path}: {value!r} not in {spec['enum']}")
    if t == "object" and isinstance(value, dict):
        props = spec.get("properties", {})
        for req in spec.get("required", ()):
            if req not in value:
                raise ValueError(f"{path}: missing required field {req!r}")
        if spec.get("additionalProperties") is False:
            extra = set(value) - set(props)
            if extra:
                raise ValueError(f"{path}: unexpected fields {sorted(extra)}")
        for name, sub in props.items():
            if name in value:
                _check(value[name], sub, f"{path}.{name}")


def validate_event(ev: dict, sch: Optional[dict] = None) -> dict:
    """Raise ValueError if ``ev`` does not conform; return ``ev``."""
    _check(ev, sch if sch is not None else schema(), "$")
    return ev


def make_event(type_: str, run: str, data: dict,
               step: Optional[int] = None, ts: Optional[float] = None) -> dict:
    ev: dict = {"type": type_, "ts": time.time() if ts is None else ts,
                "run": run, "data": data}
    if step is not None:
        ev["step"] = int(step)
    return validate_event(ev)


def append_jsonl(path: str, ev: dict) -> None:
    """Validate and append one event line (creates parent dirs)."""
    validate_event(ev)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(ev) + "\n")


def read_jsonl(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def validate_log(path: str) -> int:
    """Validate every line of a JSONL event log; returns the event count."""
    n = 0
    sch = schema()
    for ev in read_jsonl(path):
        validate_event(ev, sch)
        n += 1
    return n
