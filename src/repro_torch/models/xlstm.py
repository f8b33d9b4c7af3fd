"""xLSTM cells of the port (``src/repro/models/xlstm.py``): mLSTM (matrix
memory, parallelizable) and sLSTM (scalar memory, sequential), following
Beck et al. 2024 (arXiv:2405.04517).

mLSTM recurrence per head (state C: (dk, dv), normalizer n: (dk,)):
    C_t = f_t C_{t-1} + i_t k_t v_t^T       n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))
with an exponential input gate i = exp(i_raw) and a forget gate
f = sigmoid(f_raw), stabilized in log space by the running max m_t.  The
forward runs the chunkwise form (:func:`_mlstm_chunked`, like the SSD of
``models/ssm.py``), so no per-token (dk, dv) states are made; decode is
the O(1) recurrence (:func:`mlstm_decode`), and :func:`mlstm_reference`
is that recurrence over a whole sequence, the plain version of the
chunked form.

sLSTM: per-unit scalar memory with block-diagonal (per-head) recurrent
weights, a step at a time (:func:`_slstm_step`).

The JAX package's ``lax.scan``s (over chunks, over tokens) are Python
loops here that write nothing in place, so that the trainer's
``torch.func.vmap(grad)`` batches them; its
``associative_scan(jnp.maximum)`` is ``torch.cummax``.  The decode steps
write their fp32 states (``{C, n, m, conv}``, the sLSTM ``state`` tuple
``(c, n, h, m)``) in place into the cache, as the attention and Mamba2
caches are written, so that a stacked stage's repeats keep theirs.  The
gates, the states and the recurrences run in fp32, or in float64 when
the model's inputs are float64 (a float64 forward is the reference that
the fp32 ones are measured against).
Everything here is plain PyTorch, as it is plain ``jnp`` in the JAX
package (no Pallas kernel).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, XLSTMSpec
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_init,
                                       dense_init, draw_device, rmsnorm,
                                       rmsnorm_init)

Tensor = torch.Tensor
_F = torch.nn.functional
# the log stabilizer's empty state, and an input gate that adds nothing
_NEG = -1e30


def _wide(a: Tensor) -> Tensor:
    """``a`` in fp32, or as it is when it is wider (float64)."""
    return a.to(torch.promote_types(a.dtype, torch.float32))


def _mdims(cfg: ModelConfig, spec: XLSTMSpec) -> tuple[int, int, int]:
    d_inner = int(cfg.d_model * spec.proj_factor)
    h = cfg.n_heads
    return d_inner, h, d_inner // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, cfg: ModelConfig, spec: XLSTMSpec,
               dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_inner, h, _ = _mdims(cfg, spec)
    dev = draw_device(generator)
    return {
        "w_up": dense_init(generator, d, 2 * d_inner, dtype=dtype),  # x, z
        "conv": causal_conv1d_init(generator, d_inner, spec.conv_window,
                                   dtype),
        "wq": dense_init(generator, d_inner, d_inner, dtype=dtype),
        "wk": dense_init(generator, d_inner, d_inner, dtype=dtype),
        "wv": dense_init(generator, d_inner, d_inner, dtype=dtype),
        "w_if": dense_init(generator, d_inner, 2 * h, scale=0.02,
                           dtype=torch.float32),
        "if_bias": torch.cat([torch.zeros((h,), device=dev),
                              torch.full((h,), 3.0, device=dev)]),
        "norm": rmsnorm_init(d_inner, dtype, dev),
        "w_down": dense_init(generator, d_inner, d, dtype=dtype),
    }


def _mlstm_qkvif(params: dict, u: Tensor, cfg: ModelConfig, spec: XLSTMSpec,
                 conv_state: Tensor | None = None):
    """(q, k, v, log input gate, log forget gate, z, new conv state):
    q, k and the gates from the convolved path, v from the unconvolved
    one, k scaled by dk^-1/2, the gates in fp32."""
    d_inner, h, dk = _mdims(cfg, spec)
    x_path, z = torch.chunk(u @ params["w_up"], 2, dim=-1)
    if conv_state is None:
        xc, new_conv = causal_conv1d(params["conv"], x_path), None
    else:
        xc, new_conv = causal_conv1d(params["conv"], x_path, conv_state)
    bsz, s, _ = u.shape
    q = (xc @ params["wq"]).reshape(bsz, s, h, dk)
    k = (xc @ params["wk"]).reshape(bsz, s, h, dk) * dk ** -0.5
    v = (x_path @ params["wv"]).reshape(bsz, s, h, dk)
    gif = _wide(xc) @ params["w_if"] + params["if_bias"]
    li = gif[..., :h]
    lf = _F.logsigmoid(gif[..., h:])
    return q, k, v, li, lf, z, new_conv


def _zero_conv(params: dict, bsz: int, dtype) -> Tensor:
    w = params["conv"]["w"]
    return torch.zeros((bsz, w.shape[0] - 1, w.shape[1]), dtype=dtype,
                       device=w.device)


def _mlstm_out(params: dict, y: Tensor, z: Tensor, cfg: ModelConfig,
               dtype) -> Tensor:
    y = rmsnorm(params["norm"], y.to(dtype), cfg.norm_eps) * _F.silu(z)
    return y @ params["w_down"]


def mlstm_prefill(params: dict, u: Tensor, cfg: ModelConfig, spec: XLSTMSpec,
                  *, make_cache: bool = False):
    """u: (B, S, d_model) -> (y, cache | None); the cache is the final
    state ``{"C": (B, H, dk, dk), "n": (B, H, dk), "m": (B, H)}`` in fp32
    (float64 for a float64 ``u``) and the conv state ``"conv"`` (B, W-1, d_inner)."""
    bsz, s, _ = u.shape
    d_inner, _, _ = _mdims(cfg, spec)
    conv0 = _zero_conv(params, bsz, u.dtype) if make_cache else None
    q, k, v, li, lf, z, new_conv = _mlstm_qkvif(params, u, cfg, spec, conv0)
    y, (c, n, m) = _mlstm_chunked(q, k, v, li, lf, spec.chunk)
    out = _mlstm_out(params, y.reshape(bsz, s, d_inner), z, cfg, u.dtype)
    cache = {"C": c, "n": n, "m": m, "conv": new_conv} if make_cache \
        else None
    return out, cache


def mlstm_decode(params: dict, u: Tensor, cfg: ModelConfig, spec: XLSTMSpec,
                 cache: dict):
    """u: (B, 1, d_model); ``cache`` as :func:`mlstm_prefill` makes it,
    written in place.  Returns (y, cache)."""
    bsz = u.shape[0]
    d_inner, _, _ = _mdims(cfg, spec)
    q, k, v, li, lf, z, new_conv = _mlstm_qkvif(params, u, cfg, spec,
                                                cache["conv"])
    q1, k1, v1 = (_wide(a[:, 0]) for a in (q, k, v))
    m_new, c_new, n_new, h1 = _mlstm_step(cache["C"], cache["n"], cache["m"],
                                          q1, k1, v1, li[:, 0], lf[:, 0])
    cache["C"].copy_(c_new)
    cache["n"].copy_(n_new)
    cache["m"].copy_(m_new)
    cache["conv"].copy_(new_conv)
    return _mlstm_out(params, h1.reshape(bsz, 1, d_inner), z, cfg,
                      u.dtype), cache


def _mlstm_step(c_prev, n_prev, m_prev, q, k, v, li, lf):
    """One stabilized recurrence step: q, k, v (B, H, D) fp32 (or
    float64), li, lf (B, H).  Returns (m, C, n, h)."""
    m_new = torch.maximum(lf + m_prev, li)
    decay = torch.exp(lf + m_prev - m_new)
    gate = torch.exp(li - m_new)
    c_new = (c_prev * decay[..., None, None]
             + gate[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v))
    n_new = n_prev * decay[..., None] + gate[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, c_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    return m_new, c_new, n_new, num / den[..., None]


def init_mlstm_cache(cfg: ModelConfig, spec: XLSTMSpec, bsz: int,
                     dtype=torch.float32, device=None, lead=()) -> dict:
    """An empty decode cache (zero state, m at its empty -1e30; the state
    fp32, or float64 for a float64 model), with ``lead`` stacked axes in
    front."""
    d_inner, h, dk = _mdims(cfg, spec)
    f32 = dict(dtype=torch.promote_types(dtype, torch.float32),
               device=device)
    return {"C": torch.zeros((*lead, bsz, h, dk, dk), **f32),
            "n": torch.zeros((*lead, bsz, h, dk), **f32),
            "m": torch.full((*lead, bsz, h), _NEG, **f32),
            "conv": torch.zeros((*lead, bsz, spec.conv_window - 1, d_inner),
                                dtype=dtype, device=device)}


def _mlstm_chunked(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor,
                   chunk: int):
    """Chunkwise stabilized mLSTM.  q, k, v: (B, S, H, D); li, lf: (B, S,
    H) fp32.  Returns y (B, S, H, D) fp32 and the final (C, n, m) state
    (float64 throughout for float64 inputs).
    A sequence that is not a multiple of the chunk is padded with zero
    inputs, li = -1e30 (no input) and lf = 0 (decay 1), which carries the
    state through unchanged."""
    bsz, s0, h, dk = q.shape
    l = min(chunk, s0)
    pad = (-s0) % l
    if pad:
        def zp(a, fill=0.0):
            return torch.cat([a, a.new_full((bsz, pad, *a.shape[2:]), fill)],
                             dim=1)
        q, k, v = zp(q), zp(k), zp(v)
        li, lf = zp(li, _NEG), zp(lf)
    s = s0 + pad
    nc = s // l

    def rs(a):
        return a.reshape(bsz, nc, l, *a.shape[2:])

    qc, kc, vc = (rs(_wide(a)) for a in (q, k, v))
    lic, lfc = rs(li), rs(lf)
    cumf = torch.cumsum(lfc, dim=2)                     # within-chunk
    total = cumf[:, :, -1, :]                           # (B, NC, H)
    # per-entry source weight (log) b_j = li_j - cumf_j, and its running
    # max within the chunk (the stabilizer's local part)
    src = lic - cumf                                    # (B, NC, L, H)
    run_src = torch.cummax(src, dim=2).values
    mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()

    c_prev = qc.new_zeros((bsz, h, dk, dk))
    n_prev = qc.new_zeros((bsz, h, dk))
    m_prev = qc.new_full((bsz, h), _NEG)
    ys = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]
        cumf_b, total_b = cumf[:, c], total[:, c]
        src_b, run_src_b, lic_b = src[:, c], run_src[:, c], lic[:, c]
        # intra-chunk pair weight (log): cumf_i - cumf_j + li_j (i >= j)
        pair_b = (cumf_b[:, :, None, :] - cumf_b[:, None, :, :]
                  + lic_b[:, None, :, :])              # (B, L, L, H)
        # per-position stabilizer m_i = max(m_prev + cumf_i, cumf_i +
        # running max of src)
        m_i = torch.maximum(m_prev[:, None, :] + cumf_b, cumf_b + run_src_b)
        # inter-chunk: y_i += exp(cumf_i + m_prev - m_i) q_i . C_prev
        w_carry = torch.exp(cumf_b + m_prev[:, None, :] - m_i)  # (B, L, H)
        y_inter = torch.einsum("blhk,bhkv->blhv", qb, c_prev) \
            * w_carry[..., None]
        n_inter = torch.einsum("blhk,bhk->blh", qb, n_prev) * w_carry
        # intra-chunk: w_ij = exp(pair_ij - m_i), the mask INSIDE the exp
        # (a masked i < j entry can overflow, and the gradient through
        # where() would meet inf * 0)
        wij = torch.exp(torch.where(mask[None, :, :, None],
                                    pair_b - m_i[:, :, None, :], _NEG))
        scores = torch.einsum("blhk,bmhk->blmh", qb, kb) * wij
        y_intra = torch.einsum("blmh,bmhv->blhv", scores, vb)
        n_intra = torch.einsum("blmh,bmhk->blhk", wij, kb)
        n_intra_q = torch.einsum("blhk,blhk->blh", qb, n_intra)
        den = torch.maximum((n_inter + n_intra_q).abs(), torch.exp(-m_i))
        ys.append((y_inter + y_intra) / den[..., None])
        # the carry to the end of the chunk, with its new stabilizer
        m_new = torch.maximum(m_prev + total_b, total_b + run_src_b[:, -1, :])
        wc = torch.exp(m_prev + total_b - m_new)                  # (B, H)
        ws = torch.exp(total_b[:, None, :] + src_b - m_new[:, None, :])
        c_prev = c_prev * wc[..., None, None] + torch.einsum(
            "blh,blhk,blhv->bhkv", ws, kb, vb)
        n_prev = n_prev * wc[..., None] + torch.einsum("blh,blhk->bhk", ws,
                                                       kb)
        m_prev = m_new
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, dk)[:, :s0]
    return y, (c_prev, n_prev, m_prev)


def mlstm_reference(q: Tensor, k: Tensor, v: Tensor, li: Tensor,
                    lf: Tensor):
    """The sequential oracle of :func:`_mlstm_chunked`: the recurrence a
    decode step runs, token by token.  Returns y (B, S, H, D) fp32 (float64
    for float64 inputs) and the final (C, n, m) state."""
    bsz, s, h, dk = q.shape
    qf, kf, vf, lif, lff = (_wide(a) for a in (q, k, v, li, lf))
    c = qf.new_zeros((bsz, h, dk, dk))
    n = qf.new_zeros((bsz, h, dk))
    m = qf.new_full((bsz, h), _NEG)
    ys = []
    for t in range(s):
        m, c, n, y = _mlstm_step(c, n, m, qf[:, t], kf[:, t], vf[:, t],
                                 lif[:, t], lff[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), (c, n, m)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(generator: torch.Generator, cfg: ModelConfig, spec: XLSTMSpec,
               dtype=torch.float32) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    d_ff = int(d * spec.slstm_proj_factor)
    dev = draw_device(generator)
    return {
        # input weights of the gates (i, f, z, o), gate-major columns
        "w_in": dense_init(generator, d, 4 * d, dtype=dtype),
        # block-diagonal recurrent weights per head: (H, dh, 4 dh)
        "r": (torch.randn((h, dh, 4 * dh), generator=generator, device=dev)
              * dh ** -0.5).to(dtype),
        "bias": torch.cat([torch.zeros((d,), device=dev),
                           torch.full((d,), 3.0, device=dev),
                           torch.zeros((2 * d,), device=dev)]),
        "norm": rmsnorm_init(d, dtype, dev),
        # the position-wise gated FFN after the cell
        "w_ff_gate": dense_init(generator, d, d_ff, dtype=dtype),
        "w_ff_down": dense_init(generator, d_ff, d, dtype=dtype),
    }


def _slstm_step(params: dict, carry: tuple, wx_t: Tensor,
                cfg: ModelConfig) -> tuple:
    """One recurrence step.  carry: (c, n, h, m), each (B, d).  The
    recurrent term is laid out head-major, (B, H, 4 dh) reshaped to
    (B, 4d), and only then split into the four gates, as the JAX package
    splits it."""
    d, nh = cfg.d_model, cfg.n_heads
    c_prev, n_prev, h_prev, m_prev = carry
    bsz = c_prev.shape[0]
    hh = h_prev.reshape(bsz, nh, d // nh)
    rec = torch.einsum("bhd,hde->bhe", hh, params["r"]).reshape(bsz, 4 * d)
    g = wx_t + rec + params["bias"]
    gi, gf, gz, go = torch.chunk(_wide(g), 4, dim=-1)
    lf = _F.logsigmoid(gf)
    m_new = torch.maximum(lf + m_prev, gi)
    i_ = torch.exp(gi - m_new)
    f_ = torch.exp(lf + m_prev - m_new)
    c_new = f_ * c_prev + i_ * torch.tanh(gz)
    n_new = torch.maximum(f_ * n_prev + i_, torch.exp(-m_new))
    h_new = torch.sigmoid(go) * c_new / n_new
    return c_new, n_new, h_new, m_new


def _slstm_out(params: dict, y: Tensor, cfg: ModelConfig) -> Tensor:
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return _F.silu(y @ params["w_ff_gate"]) @ params["w_ff_down"]


def slstm_prefill(params: dict, u: Tensor, cfg: ModelConfig, spec: XLSTMSpec,
                  *, make_cache: bool = False):
    """u: (B, S, d_model) -> (y, cache | None); the cache is
    ``{"state": (c, n, h, m)}``, each (B, d) fp32 (float64 for a float64
    ``u``)."""
    bsz, s, _ = u.shape
    wx = u @ params["w_in"]                                  # (B, S, 4d)
    carry = init_slstm_cache(cfg, bsz, device=u.device,
                             dtype=u.dtype)["state"]
    hs = []
    for t in range(s):
        carry = _slstm_step(params, carry, wx[:, t], cfg)
        hs.append(carry[2])
    y = _slstm_out(params, torch.stack(hs, dim=1).to(u.dtype), cfg)
    return y, ({"state": carry} if make_cache else None)


def slstm_decode(params: dict, u: Tensor, cfg: ModelConfig, spec: XLSTMSpec,
                 cache: dict):
    """u: (B, 1, d_model); ``cache`` ``{"state": (c, n, h, m)}``, written
    in place.  Returns (y, cache)."""
    new = _slstm_step(params, cache["state"], (u @ params["w_in"])[:, 0],
                      cfg)
    for old, value in zip(cache["state"], new):
        old.copy_(value)
    return _slstm_out(params, new[2][:, None].to(u.dtype), cfg), cache


def init_slstm_cache(cfg: ModelConfig, bsz: int, device=None,
                     lead=(), dtype=torch.float32) -> dict:
    """An empty sLSTM state ``{"state": (c, n, h, m)}``, fp32 (float64
    for a float64 model), with ``lead`` stacked axes in front: n starts
    at ones and m at -1e30."""
    shape = (*lead, bsz, cfg.d_model)
    f32 = dict(dtype=torch.promote_types(dtype, torch.float32),
               device=device)
    return {"state": (torch.zeros(shape, **f32), torch.ones(shape, **f32),
                      torch.zeros(shape, **f32),
                      torch.full(shape, _NEG, **f32))}
