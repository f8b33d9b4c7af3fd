"""Plain PyTorch versions of the port's kernels.

They keep the interfaces of the JAX package's oracles
(``src/repro/kernels/ref.py``), so the tests compare them one to one, and
they are what ``ops.py`` runs for a tensor on the CPU.  On the card,
``chip_smoke.py`` holds every CUDA kernel against them.  Each operation is
a separate PyTorch call, so every elementwise result is rounded on its own
(no FMA contraction); the ring combines, fp32 and int8, are bitwise the
CUDA kernels'.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Stiefel tangent projection
# ---------------------------------------------------------------------------


def stiefel_project_ref(x: Tensor, g: Tensor) -> Tensor:
    """P_{T_x}(g) = g - x sym(x^T g)  over the last two dims."""
    xtg = torch.einsum("...dr,...ds->...rs", x, g)
    s = 0.5 * (xtg + xtg.transpose(-1, -2))
    return g - torch.einsum("...dr,...rs->...ds", x, s)


# ---------------------------------------------------------------------------
# fused polar retraction (tangent project + Gram + NS inverse sqrt + apply)
# ---------------------------------------------------------------------------


def invsqrt_newton_schulz(a: Tensor, iters: int = 20) -> Tensor:
    """Inverse square root of SPD ``a`` by the coupled Newton--Schulz
    iteration, after scaling by the induced inf-norm (max abs row sum),
    which bounds the spectrum of the symmetric ``a`` so that it lies in
    (0, 1].  The iteration of ``geometry/stiefel.py`` in the JAX package."""
    r = a.shape[-1]
    eye = torch.eye(r, dtype=a.dtype, device=a.device)
    c = a.abs().sum(-1).amax(-1)[..., None, None] + 1e-6
    y = a / c
    z = eye.expand(a.shape)
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    # z ~ (a/c)^{-1/2}  =>  a^{-1/2} = z / sqrt(c)
    return z * torch.rsqrt(c)


def fused_retract_ref(x: Tensor, g: Tensor, ns_iters: int = 20) -> Tensor:
    """R_x(P_x(g)): polar retraction of the tangent-projected AMBIENT
    direction ``g``, the fused kernel's function, computed without the
    Gram identity the kernel uses."""
    u = stiefel_project_ref(x, g)
    r = u.shape[-1]
    utu = torch.einsum("...dr,...ds->...rs", u, u)
    a = torch.eye(r, dtype=u.dtype, device=u.device) + utu
    inv = invsqrt_newton_schulz(a, ns_iters)
    return torch.einsum("...dr,...rs->...ds", x + u, inv)


# ---------------------------------------------------------------------------
# ring gossip mix
# ---------------------------------------------------------------------------


def ring_mix_ref(x_self: Tensor, x_left: Tensor, x_right: Tensor,
                 w_self: float, w_side: float) -> Tensor:
    """One gossip hop's local combine: wc*x + ws*(left + right)."""
    return w_self * x_self + w_side * (x_left + x_right)


# ---------------------------------------------------------------------------
# fused multi-hop ring mix (halo panel)
# ---------------------------------------------------------------------------


def _panel_hop(z: Tensor, w_self: float, w_side: float) -> Tensor:
    """One ring combine on the interior rows of a halo panel: row ``i``'s
    neighbours are rows ``i-1`` / ``i+1``; the two boundary rows drop out."""
    return w_self * z[1:-1] + w_side * (z[:-2] + z[2:])


def multi_hop_mix_ref(panel: Tensor, *, hops: int, out_rows: int, halo: int,
                      w_self: float, w_side: float) -> Tensor:
    """``hops`` ring combines over a ``(halo + b + halo, F)`` panel; returns
    the exact center ``(out_rows, F)`` rows (``halo >= hops``).  Each hop
    shrinks the live window by one row per side."""
    z = panel.to(torch.float32)
    for _ in range(hops):
        z = _panel_hop(z, w_self, w_side)
    lo = halo - hops
    return z[lo:lo + out_rows].to(panel.dtype)


def ring_panel(x: Tensor, halo: int) -> Tensor:
    """The wrapped halo panel of a node-stacked leaf: row ``j`` of the
    ``(n + 2 halo, F)`` result is node ``(j - halo) mod n``.  On it,
    :func:`multi_hop_mix_ref` with ``out_rows = n`` computes ``hops <= halo``
    ring hops of the whole ring, and so does
    :func:`multi_hop_mix_quant_ref` in rows ``halo : halo + n``."""
    n = x.shape[0]
    idx = (torch.arange(n + 2 * halo, device=x.device) - halo) % n
    return x.reshape(n, -1)[idx]


# ---------------------------------------------------------------------------
# int8 all-hop ring mix (halo panel)
# ---------------------------------------------------------------------------


def _shift_down(z: Tensor) -> Tensor:
    """Row i-1's value at row i; zeros shifted in at the top."""
    return torch.cat([torch.zeros_like(z[:1]), z[:-1]], dim=0)


def _shift_up(z: Tensor) -> Tensor:
    """Row i+1's value at row i; zeros shifted in at the bottom."""
    return torch.cat([z[1:], torch.zeros_like(z[:1])], dim=0)


def _panel_hop_dq(q: Tensor, s: Tensor, w_self: float,
                  w_side: float) -> Tensor:
    """One ring combine on quantized panel values with per-row scales,
    dequantizing each shifted operand separately:
    ``wc*(q_i s_i) + ws*((q_{i-1} s_{i-1}) + (q_{i+1} s_{i+1}))``, the
    dataflow of :func:`quant_mix_ref`.  The two boundary rows see zeros."""
    return (w_self * (q * s)
            + w_side * (_shift_down(q) * _shift_down(s)
                        + _shift_up(q) * _shift_up(s)))


def multi_hop_mix_quant_ref(q_panel: Tensor, s_panel: Tensor, *, hops: int,
                            w_self: float, w_side: float) -> Tensor:
    """All-hop compressed schedule on an int8 halo panel: hop 0 fuses
    dequantize + combine, every later hop requantizes deterministically
    (round half to even, per-row max-abs/127 scale, 1e-12 floor; the
    formula of ``comms.compress.quantize_det``) before combining.  Returns
    the full evolved f32 panel; the exact rows are the center ones
    (``halo >= hops``).  The divisor 127 is a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead."""
    z = _panel_hop_dq(q_panel.to(torch.float32), s_panel.to(torch.float32),
                      w_self, w_side)
    for _ in range(1, hops):
        amax = torch.amax(z.abs(), dim=1, keepdim=True)
        scale = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
        q = torch.clamp(torch.round(z / scale), -127.0, 127.0)
        z = _panel_hop_dq(q, scale, w_self, w_side)
    return z


# ---------------------------------------------------------------------------
# fused dequantize + ring combine
# ---------------------------------------------------------------------------


def quant_mix_ref(q_self: Tensor, q_left: Tensor, q_right: Tensor,
                  s_self: Tensor, s_left: Tensor, s_right: Tensor,
                  w_self: float, w_side: float) -> Tensor:
    """Compressed gossip hop's combine on int8 payloads with per-row scales:
    out = wc * dq(qc) + ws * (dq(ql) + dq(qr)), dq(q) = q * scale, f32."""
    def dq(q, s):
        return q.to(torch.float32) * s.to(torch.float32)

    return (w_self * dq(q_self, s_self)
            + w_side * (dq(q_left, s_left) + dq(q_right, s_right)))
