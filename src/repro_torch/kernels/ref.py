"""Plain PyTorch versions of the port's kernels.

They keep the interfaces of the JAX package's oracles
(``src/repro/kernels/ref.py``), so the tests compare them one to one, and
they are what ``ops.py`` runs for a tensor on the CPU.  On the card,
``chip_smoke.py`` holds every CUDA kernel against them.  Each operation is
a separate PyTorch call, so every elementwise result is rounded on its own
(no FMA contraction); the ring combines, fp32 and int8, are bitwise the
CUDA kernels'.

The attention versions follow the Pallas kernels where the JAX package's
oracles differ from them: a query row with no unmasked key comes out as
exact zeros (the oracles' softmax gives the mean of the values there).
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


# ---------------------------------------------------------------------------
# attention (q (B, S, H, hd); k/v (B, T, Hkv, hd/hdv); GQA by head groups)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _positions(q: Tensor, k: Tensor, q_positions, kv_positions):
    b, s = q.shape[:2]
    t = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(s, device=q.device).expand(b, s)
    if kv_positions is None:
        kv_positions = torch.arange(t, device=q.device).expand(b, t)
    return q_positions, kv_positions


def _attn_mask(q_pos: Tensor, kv_pos: Tensor, causal: bool,
               window: int | None) -> Tensor:
    """(B, S, T) bool: key usable by query.  kv positions < 0 mark empty
    cache rows; causal keeps kv_pos <= q_pos; a window keeps
    q_pos - kv_pos < window."""
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return mask


def attention_naive(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None, q_positions=None,
                    kv_positions=None,
                    softmax_scale: float | None = None) -> Tensor:
    """Attention with the full (S, T) scores in fp32; returns (B, S, H, hdv)
    in q's dtype.  H must be a multiple of Hkv (kv heads are shared by
    groups of H / Hkv query heads)."""
    b, s, h, hd = q.shape
    t, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    q_pos, kv_pos = _positions(q, k, q_positions, kv_positions)
    qg = q.float().reshape(b, s, hkv, h // hkv, hd) * scale
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    mask = _attn_mask(q_pos, kv_pos, causal, window)[:, None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    # masked probabilities are zero, so a row with no key gives exact
    # zeros, as the Pallas kernel does
    p = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    out = torch.einsum("bhgst,bthe->bshge", p, v.float())
    return out.reshape(b, s, h, hdv).to(q.dtype)


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_positions=None, kv_positions=None,
                        softmax_scale: float | None = None,
                        chunk: int = 1024) -> Tensor:
    """Online-softmax attention streaming over KV chunks of ``chunk`` keys,
    the arithmetic of the Pallas kernel: scaled q, fp32 scores, masked
    probabilities set to zero, ``acc / max(l, 1e-30)`` at the end.  Same
    signature and layouts as :func:`attention_naive`."""
    b, s, h, hd = q.shape
    t, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    q_pos, kv_pos = _positions(q, k, q_positions, kv_positions)
    qf = (q.float() * scale).reshape(b, s, hkv, h // hkv, hd)
    m = torch.full((b, hkv, h // hkv, s), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, h // hkv, s), device=q.device)
    acc = torch.zeros((b, hkv, h // hkv, s, hdv), device=q.device)
    for t0 in range(0, t, chunk):
        kb = k[:, t0:t0 + chunk].float()
        vb = v[:, t0:t0 + chunk].float()
        mask = _attn_mask(q_pos, kv_pos[:, t0:t0 + chunk], causal,
                          window)[:, None, None]
        sc = torch.einsum("bshgd,bthd->bhgst", qf, kb).masked_fill(
            ~mask, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None]).masked_fill(~mask, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgst,bthe->bhgse", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hdv)
    return out.to(q.dtype)


def attention_lse(q: Tensor, k: Tensor, *, causal: bool = True,
                  window: int | None = None, q_positions=None,
                  kv_positions=None,
                  softmax_scale: float | None = None) -> Tensor:
    """(B, H, S) fp32: each query row's log-sum-exp of its scaled scores
    over its usable keys, ``m + log(max(l, tiny))``, which the CUDA
    forward writes beside its output for the backward kernel (a row
    without keys gets about -1e30 and is never read)."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    q_pos, kv_pos = _positions(q, k, q_positions, kv_positions)
    qg = q.float().reshape(b, s, hkv, h // hkv, hd) * scale
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    mask = _attn_mask(q_pos, kv_pos, causal, window)[:, None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None]).masked_fill(~mask, 0.0)
    lse = m + torch.log(torch.clamp(e.sum(dim=-1),
                                    min=torch.finfo(torch.float32).tiny))
    return lse.reshape(b, h, s)


def attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                       d_out: Tensor, *, causal: bool = True,
                       window: int | None = None, q_positions=None,
                       kv_positions=None,
                       softmax_scale: float | None = None
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """The gradient of :func:`blockwise_attention` (and of the CUDA
    flash_attention): given its inputs, its output ``out`` (B, S, H, hdv)
    and the cotangent ``d_out``, returns (dq, dk, dv) in the inputs'
    dtypes, by the explicit formulas in fp32:

        P  = the masked softmax probabilities (0 on masked keys)
        D  = rowsum(d_out * out)
        dS = P * (d_out v^T - D)
        dq = scale dS k,  dk = scale dS^T q,  dv = P^T d_out

    with dk and dv summed over the query heads of each GQA group.  A query
    with no usable key has P = 0 (and zero output): it passes zero
    gradient.  Full (S, T) scores per head, as :func:`attention_naive`."""
    b, s, h, hd = q.shape
    t, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    q_pos, kv_pos = _positions(q, k, q_positions, kv_positions)
    qg = q.float().reshape(b, s, hkv, g, hd)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg * scale, kf)
    mask = _attn_mask(q_pos, kv_pos, causal, window)[:, None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m).masked_fill(~mask, 0.0)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    dog = d_out.float().reshape(b, s, hkv, g, hdv)
    d_rows = (dog * out.float().reshape(b, s, hkv, g, hdv)).sum(-1)
    dp = torch.einsum("bshge,bthe->bhgst", dog, vf)
    ds = p * (dp - d_rows.permute(0, 2, 3, 1)[..., None])
    dq = scale * torch.einsum("bhgst,bthd->bshgd", ds, kf)
    dk = scale * torch.einsum("bhgst,bshgd->bthd", ds, qg)
    dv = torch.einsum("bhgst,bshge->bthe", p, dog)
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_decode_attention_ref(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                               block_table: Tensor, seq_lens: Tensor, *,
                               window: int | None = None,
                               softmax_scale: float | None = None) -> Tensor:
    """One decode token per slot over a paged KV pool: gather every slot's
    pages through the block table into a contiguous (S, M*ps, Hkv, hd)
    view, then :func:`blockwise_attention` with positions from the page
    layout.

    q (S, H, hd); pools (P, ps, Hkv, hd/hdv); block_table (S, M) integer
    (-1 = unallocated, read as the dump page 0 and masked); seq_lens (S,)
    integer, the valid tokens with the query at ``seq_lens - 1``.  A slot
    with ``seq_lens == 0`` has no key and returns exact zeros.
    """
    s_slots = q.shape[0]
    ps, hkv, hd = k_pages.shape[1:]
    hdv = v_pages.shape[-1]
    m_pages = block_table.shape[1]
    bt = block_table.long().clamp(min=0)
    k = k_pages[bt].reshape(s_slots, m_pages * ps, hkv, hd)
    v = v_pages[bt].reshape(s_slots, m_pages * ps, hkv, hdv)
    pos = torch.arange(m_pages * ps, device=q.device)[None, :]
    seq = seq_lens.long()[:, None]
    kv_pos = torch.where(pos < seq, pos, -1)
    return blockwise_attention(q[:, None], k, v, causal=True, window=window,
                               q_positions=seq - 1, kv_positions=kv_pos,
                               softmax_scale=softmax_scale)[:, 0]
