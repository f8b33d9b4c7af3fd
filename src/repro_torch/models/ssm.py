"""Mamba2 (SSD) block of the port (``src/repro/models/ssm.py``): the
chunked selective-state-space computation.

Recurrence (per head h, state (N, P)):   H_t = a_t H_{t-1} + B_t (dt_t x_t)^T
Output:                                  y_t = C_t · H_t + D x_t

The forward uses the chunked SSD algorithm (Dao & Gu, 2024): the
quadratic, attention-like form inside chunks of length L and a sequential
carry across the S/L chunks (``lax.scan`` in the JAX package, a Python
loop here that writes nothing in place, so that the trainer's
``torch.func.vmap(grad)`` batches it).  Decode is the single-step
recurrence on a cached fp32 state, written in place into the cache as the
attention caches are.  The tensors stay (B, S, H, ·): no (B, S, H, N, P)
per-token states are made.  Everything here is plain PyTorch, as it is
plain ``jnp`` in the JAX package (no Pallas kernel): the projections, the
causal convolution and the scan.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, SSMSpec
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_init,
                                       dense_init, draw_device, rmsnorm,
                                       rmsnorm_init)

Tensor = torch.Tensor


def _dims(cfg: ModelConfig, spec: SSMSpec) -> tuple[int, int]:
    d_inner = spec.expand * cfg.d_model
    return d_inner, d_inner // spec.head_dim


def init_mamba(generator: torch.Generator, cfg: ModelConfig, spec: SSMSpec,
               dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_inner, h = _dims(cfg, spec)
    g, n = spec.n_groups, spec.d_state
    dev = draw_device(generator)
    return {
        "in_proj": dense_init(generator, d, 2 * d_inner + 2 * g * n + h,
                              dtype=dtype),
        "conv": causal_conv1d_init(generator, d_inner + 2 * g * n,
                                   spec.d_conv, dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, dtype, dev),
        "out_proj": dense_init(generator, d_inner, d, dtype=dtype),
    }


def _split_proj(params: dict, u: Tensor, cfg: ModelConfig, spec: SSMSpec):
    """(z, xbc, dt_raw) of the input projection; ``torch.split`` takes the
    sizes where ``jnp.split`` takes the indices."""
    d_inner, h = _dims(cfg, spec)
    gn = spec.n_groups * spec.d_state
    return torch.split(u @ params["in_proj"], [d_inner, d_inner + 2 * gn, h],
                       dim=-1)


def _gates(params: dict, xbc_conv: Tensor, dt_raw: Tensor, cfg: ModelConfig,
           spec: SSMSpec):
    """(x, B, C, dt, log decay): x (.., H, P); B, C (.., H, N), each group
    repeated over its ``H / n_groups`` consecutive heads (``jnp.repeat``,
    which is ``repeat_interleave``); dt the softplus of the raw step plus
    its bias, fp32; log decay ``-dt * exp(a_log) <= 0``."""
    d_inner, h = _dims(cfg, spec)
    g, n, p = spec.n_groups, spec.d_state, spec.head_dim
    x, b_, c_ = torch.split(xbc_conv, [d_inner, g * n, g * n], dim=-1)
    lead = x.shape[:-1]
    x = x.reshape(*lead, h, p)
    rep = h // g
    b_ = b_.reshape(*lead, g, n).repeat_interleave(rep, dim=-2)
    c_ = c_.reshape(*lead, g, n).repeat_interleave(rep, dim=-2)
    pre = dt_raw.float() + params["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))   # jax.nn.softplus
    la = -dt * torch.exp(params["a_log"])
    return x, b_, c_, dt, la


def _zero_conv_state(params: dict, bsz: int, dtype) -> Tensor:
    w = params["conv"]["w"]
    return torch.zeros((bsz, w.shape[0] - 1, w.shape[1]), dtype=dtype,
                       device=w.device)


def _out(params: dict, y: Tensor, z: Tensor, cfg: ModelConfig) -> Tensor:
    y = rmsnorm(params["norm"], y * torch.nn.functional.silu(z),
                cfg.norm_eps)
    return y @ params["out_proj"]


def mamba_prefill(params: dict, u: Tensor, cfg: ModelConfig, spec: SSMSpec,
                  *, make_cache: bool = False):
    """u: (B, S, d_model) -> (y, cache | None); the cache is the final
    state ``{"ssm": (B, H, N, P) fp32, "conv": (B, W-1, C)}``."""
    bsz, s, _ = u.shape
    d_inner, _ = _dims(cfg, spec)
    z, xbc, dt_raw = _split_proj(params, u, cfg, spec)
    if make_cache:
        xbc_conv, conv_state = causal_conv1d(
            params["conv"], xbc, _zero_conv_state(params, bsz, xbc.dtype))
    else:
        xbc_conv, conv_state = causal_conv1d(params["conv"], xbc), None
    x, b_, c_, dt, la = _gates(params, xbc_conv, dt_raw, cfg, spec)
    y, final_state = _ssd_chunked(x, b_, c_, dt, la, spec.chunk)
    y = y + x.float() * params["d_skip"][:, None]
    y = y.reshape(bsz, s, d_inner).to(u.dtype)
    cache = {"ssm": final_state, "conv": conv_state} if make_cache else None
    return _out(params, y, z, cfg), cache


def mamba_decode(params: dict, u: Tensor, cfg: ModelConfig, spec: SSMSpec,
                 cache: dict):
    """u: (B, 1, d_model); cache ``{"ssm": (B, H, N, P) fp32, "conv":
    (B, W-1, C)}``, written in place.  Returns (y, cache)."""
    bsz = u.shape[0]
    d_inner, _ = _dims(cfg, spec)
    z, xbc, dt_raw = _split_proj(params, u, cfg, spec)
    xbc_conv, conv_state = causal_conv1d(params["conv"], xbc, cache["conv"])
    x, b_, c_, dt, la = _gates(params, xbc_conv, dt_raw, cfg, spec)
    x1 = x[:, 0].float()                          # (B, H, P)
    b1 = b_[:, 0].float()                         # (B, H, N)
    c1 = c_[:, 0].float()
    dt1 = dt[:, 0]                                # (B, H)
    a1 = torch.exp(la[:, 0])
    hst = cache["ssm"] * a1[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", b1, x1 * dt1[..., None])
    y1 = torch.einsum("bhn,bhnp->bhp", c1, hst) \
        + x1 * params["d_skip"][:, None]
    y = y1.reshape(bsz, 1, d_inner).to(u.dtype)
    cache["ssm"].copy_(hst)
    cache["conv"].copy_(conv_state)
    return _out(params, y, z, cfg), cache


def init_mamba_cache(cfg: ModelConfig, spec: SSMSpec, bsz: int,
                     dtype=torch.float32, device=None, lead=()) -> dict:
    """An empty decode cache (zeros), with ``lead`` stacked axes in
    front."""
    d_inner, h = _dims(cfg, spec)
    conv_c = d_inner + 2 * spec.n_groups * spec.d_state
    return {"ssm": torch.zeros((*lead, bsz, h, spec.d_state, spec.head_dim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, bsz, spec.d_conv - 1, conv_c),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# chunked SSD core
# ---------------------------------------------------------------------------


def _ssd_chunked(x: Tensor, b_: Tensor, c_: Tensor, dt: Tensor,
                 la: Tensor, chunk: int) -> tuple[Tensor, Tensor]:
    """x: (B, S, H, P); b_, c_: (B, S, H, N); dt, la: (B, S, H).  Returns
    y (B, S, H, P) fp32 and the final state (B, H, N, P) fp32.  A
    sequence that is not a multiple of the chunk is padded with zero
    inputs and zero log decay (a = 1), which carries the state through
    unchanged."""
    bsz, s0, h, p = x.shape
    n = b_.shape[-1]
    l = min(chunk, s0)
    pad = (-s0) % l
    if pad:
        def zp(a):
            return torch.cat([a, a.new_zeros((bsz, pad, *a.shape[2:]))],
                             dim=1)
        x, b_, c_, dt, la = zp(x), zp(b_), zp(c_), zp(dt), zp(la)
    s = s0 + pad
    nc = s // l

    xb = (x.float() * dt[..., None]).reshape(bsz, nc, l, h, p)
    bb = b_.float().reshape(bsz, nc, l, h, n)
    cb = c_.float().reshape(bsz, nc, l, h, n)
    lab = la.reshape(bsz, nc, l, h)

    cum = torch.cumsum(lab, dim=2)                   # within-chunk
    total = cum[:, :, -1, :]                         # (B, NC, H)

    # intra-chunk quadratic form: w_ij = exp(cum_i - cum_j) for i >= j.
    # The mask stays INSIDE the exp: a masked (i < j) entry has diff > 0
    # and would overflow to inf, and the gradient through where() would
    # be NaN.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,L,L,H)
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    w = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                              torch.full_like(diff, -1e30)))
    scores = torch.einsum("bclhn,bcmhn->bclmh", cb, bb) * w
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", scores, xb)

    # chunk summary states: S_c = sum_j exp(total - cum_j) B_j x_j^T
    decay_tail = torch.exp(total[:, :, None, :] - cum)       # (B,NC,L,H)
    st = torch.einsum("bclh,bclhn,bclhp->bchnp", decay_tail, bb, xb)

    # the sequential carry over chunks: H_c = H_{c-1} exp(total_c) + S_c,
    # each chunk reading the state before it
    hprev = x.new_zeros((bsz, h, n, p), dtype=torch.float32)
    hprevs = []
    for c in range(nc):
        hprevs.append(hprev)
        hprev = hprev * torch.exp(total[:, c])[..., None, None] + st[:, c]
    hprevs = torch.stack(hprevs, dim=1)                      # (B,NC,H,N,P)

    # inter-chunk contribution: y_i += exp(cum_i) C_i · H_{c-1}
    y_inter = torch.einsum("bclh,bclhn,bchnp->bclhp", torch.exp(cum), cb,
                           hprevs)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :s0]
    return y, hprev


def ssd_reference(x: Tensor, b_: Tensor, c_: Tensor, dt: Tensor,
                  la: Tensor) -> tuple[Tensor, Tensor]:
    """The O(S) sequential oracle of :func:`_ssd_chunked`: the plain
    recurrence, token by token."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    xb = x.float() * dt[..., None]
    bf, cf = b_.float(), c_.float()
    hst = x.new_zeros((bsz, h, n, p), dtype=torch.float32)
    ys = []
    for t in range(s):
        hst = hst * torch.exp(la[:, t])[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bf[:, t], xb[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], hst))
    return torch.stack(ys, dim=1), hst
