"""Analytical per-kernel cost estimates and their aggregation.

Mirrors ``src/repro/obs/estimates.py``, formula for formula.  Every kernel
call is described by an :class:`Estimates` triple

  ``ops`` -- floating-point operations,
  ``lds`` -- bytes moved through loads and stores (revisits counted),
  ``mem`` -- unique bytes touched (what an ideal cache moves),

derived from shapes only, so the numbers are the same on the CPU and on
the card, and the same whichever implementation runs the call.
``launch/roofline.py`` places them on a hardware roofline.

``kernels/ops.py``'s dispatch wrappers record one estimate per launch into
every active :func:`collect` scope, under the JAX package's kernel names:
on the card where the kernel launches, on the CPU where the plain version
runs, as the JAX package records under ``impl="ref"``.  The JAX package
also keeps an always-on ``GLOBAL`` record, which nothing in the port
reads; here a wrapper called outside every scope works out no estimate at
all (:func:`collecting`), so the main path pays nothing for them.  A grouped call (one launch for up to 16 leaves of a tree)
records the sum of its leaves' estimates once.  The port runs eagerly, so
the records count executed calls: a step run T times records T times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading


@dataclasses.dataclass(frozen=True)
class Estimates:
    """Analytical cost of one kernel call."""
    ops: float = 0.0   # floating-point operations
    lds: float = 0.0   # bytes served by loads + stores (revisits counted)
    mem: float = 0.0   # unique bytes touched

    def __add__(self, o: "Estimates") -> "Estimates":
        return Estimates(self.ops + o.ops, self.lds + o.lds, self.mem + o.mem)

    def scaled(self, k: float) -> "Estimates":
        return Estimates(self.ops * k, self.lds * k, self.mem * k)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in FLOP/byte (ops over unique bytes)."""
        return self.ops / max(self.mem, 1.0)

    def as_dict(self) -> dict:
        return {"ops": self.ops, "lds": self.lds, "mem": self.mem,
                "intensity": self.intensity}


# ---------------------------------------------------------------------------
# per-kernel analytical models (shapes in, Estimates out)
# ---------------------------------------------------------------------------


def flash_attention_est(b: int, s: int, t: int, h: int, hd: int, *,
                        causal: bool = True, window: int | None = None,
                        block_q: int = 128, itemsize: int = 4) -> Estimates:
    """Blockwise attention over (B, H, S, hd) x (B, H, T, hd).

    Two matmuls (QK^T and PV) at 2*s*t*hd each plus ~5 flop/score for the
    online softmax; a causal square mask halves the visited score area, a
    sliding window caps each query's keys at ``window``.
    """
    t_eff = float(min(t, window)) if window else float(t)
    frac = 0.5 if (causal and s == t and not window) else 1.0
    scores = b * h * s * t_eff * frac
    ops = scores * (4.0 * hd + 5.0)
    # q streamed once; k/v re-read once per q block (the flash loop)
    q_blocks = max(1, -(-s // max(block_q, 1)))
    lds = itemsize * b * h * (2.0 * s * hd + 2.0 * q_blocks * t * hd * frac)
    mem = itemsize * b * h * (2.0 * s * hd + 2.0 * t * hd)
    return Estimates(ops=ops, lds=lds, mem=mem)


def paged_decode_est(s: int, h: int, hkv: int, hd: int, m_pages: int,
                     page_size: int, *, itemsize: int = 4) -> Estimates:
    """Paged-decode attention: one query token per slot over ``m_pages``
    block-table pages of ``page_size`` tokens.  Same 4*hd+5 flop/score core
    as flash attention; k/v pages stream once per (slot, kv-head) pair, q/o
    are one token per slot."""
    t = float(m_pages) * page_size
    scores = float(s) * h * t
    ops = scores * (4.0 * hd + 5.0)
    qo = 2.0 * s * h * hd
    kv = 2.0 * s * hkv * t * hd
    lds = itemsize * (qo + kv)
    mem = itemsize * (qo + kv)      # pages are slot-private (no sharing)
    return Estimates(ops=ops, lds=lds, mem=mem)


def stiefel_project_est(d: int, r: int, *, lead: int = 1,
                        itemsize: int = 4) -> Estimates:
    """P_{T_x}(g) = g - x sym(x^T g): two d x r x r matmuls + r^2 sym."""
    ops = lead * (4.0 * d * r * r + 2.0 * r * r + d * r)
    lds = itemsize * lead * (4.0 * d * r)      # x read twice, g once, out once
    mem = itemsize * lead * (3.0 * d * r)
    return Estimates(ops=ops, lds=lds, mem=mem)


def fused_retract_est(d: int, r: int, *, ns_iters: int = 20, lead: int = 1,
                      itemsize: int = 4) -> Estimates:
    """Fused polar retraction: tangent project + Gram + Newton-Schulz
    inverse-sqrt (r x r, ``ns_iters`` iterations at ~2 matmuls each) + apply,
    in one kernel."""
    grams = 6.0 * d * r * r              # x^T x, x^T g, cross terms (pass 1)
    ns = ns_iters * 4.0 * r ** 3         # two r x r matmuls per NS iteration
    apply = 2.0 * d * r * r + 4.0 * d * r   # (x + u) @ invsqrt + u assembly
    ops = lead * (grams + ns + apply)
    # two passes over both d x r operands + one output write
    lds = itemsize * lead * (4.0 * d * r + d * r)
    mem = itemsize * lead * (3.0 * d * r)
    return Estimates(ops=ops, lds=lds, mem=mem)


def ring_mix_est(n_elems: int, *, itemsize: int = 4) -> Estimates:
    """wc*x + ws*(l + r): 4 flop/element over three inputs, one output."""
    return Estimates(ops=4.0 * n_elems,
                     lds=itemsize * 4.0 * n_elems,
                     mem=itemsize * 4.0 * n_elems)


def quant_mix_est(rows: int, cols: int, *, out_itemsize: int = 4) -> Estimates:
    """Fused dequantize + 3-way combine: 3 dequant muls + 4 combine flops per
    element; loads are int8 payloads + one f32 scale per row."""
    n = float(rows) * cols
    ops = 7.0 * n
    lds = 3.0 * n + 3.0 * 4.0 * rows + out_itemsize * n
    mem = lds
    return Estimates(ops=ops, lds=lds, mem=mem)


def multi_hop_mix_est(rows: int, f: int, *, hops: int, out_rows: int,
                      itemsize: int = 4, quant: bool = False) -> Estimates:
    """Fused k-hop halo-panel combine.

    fp32: one panel read, ``hops`` combines at 4 flop/element, one
    ``(out_rows, f)`` write.  int8 all-hop: the payload arrives as 1
    byte/element (+4 B/row scales), hop 0 adds 1 dequant mul/element, later
    hops add a ~4 flop/element requant (div, round, clip, mul) and revisit
    the f32 state panel once per stage (max pass + combine pass)."""
    n = float(rows) * f
    ops = 4.0 * hops * n
    if quant:
        ops += n + 4.0 * max(hops - 1, 0) * n       # dequant + requants
        in_bytes = 1.0 * n + 4.0 * rows
        # state panel written at every combine stage, re-read at every
        # max + requant stage
        lds = in_bytes + 4.0 * n * (3.0 * max(hops - 1, 0) + 1.0)
        mem = in_bytes + 4.0 * n
    else:
        in_bytes = float(itemsize) * n
        lds = in_bytes + float(itemsize) * out_rows * f
        mem = lds
    return Estimates(ops=ops, lds=lds, mem=mem)


#: the registered estimators, keyed by the ops.py dispatch name
KERNELS = {
    "flash_attention": flash_attention_est,
    "paged_decode": paged_decode_est,
    "stiefel_project": stiefel_project_est,
    "fused_retract": fused_retract_est,
    "ring_mix": ring_mix_est,
    "quant_mix": quant_mix_est,
    "multi_hop_mix": multi_hop_mix_est,
    "multi_hop_mix_quant": functools.partial(multi_hop_mix_est, quant=True),
}


# ---------------------------------------------------------------------------
# per-call aggregation
# ---------------------------------------------------------------------------


class KernelCounters:
    """Aggregates (calls, Estimates) per kernel name."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records: dict[str, dict] = {}

    def record(self, name: str, est: Estimates) -> None:
        with self._lock:
            rec = self.records.setdefault(
                name, {"calls": 0, "est": Estimates()})
            rec["calls"] += 1
            rec["est"] = rec["est"] + est

    def snapshot(self) -> dict:
        """JSON-able {kernel: {calls, ops, lds, mem, intensity}}."""
        with self._lock:
            return {name: {"calls": rec["calls"], **rec["est"].as_dict()}
                    for name, rec in sorted(self.records.items())}

    def reset(self) -> None:
        with self._lock:
            self.records.clear()


_STACK: list[KernelCounters] = []


def collecting() -> bool:
    """True inside a :func:`collect` scope (a record has a reader)."""
    return bool(_STACK)


def record(name: str, est: Estimates) -> None:
    """Record one kernel call into every active collect() scope."""
    for c in _STACK:
        c.record(name, est)


@contextlib.contextmanager
def collect():
    """Scoped collector: ``with collect() as c: ...; c.snapshot()``."""
    c = KernelCounters()
    _STACK.append(c)
    try:
        yield c
    finally:
        _STACK.remove(c)
