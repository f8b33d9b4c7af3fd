"""Shared neural building blocks of the port (``src/repro/models/layers.py``):
initializers from an explicit ``torch.Generator``, RMSNorm, SwiGLU and
rotary position embeddings, as plain functions over dicts of tensors.

Initializers draw on the generator's device and cast to ``dtype`` (with
no generator, they make ``meta`` tensors: shapes only, no draws); the
numbers differ from the JAX package's (another generator), so tests carry
weights over with ``repro_torch.convert``.  Weights are ``x @ W`` with W
as (d_in, d_out), the JAX package's layout.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def draw_device(generator: torch.Generator | None):
    """Where an initializer draws: the generator's device, ``meta`` without
    one."""
    return "meta" if generator is None else generator.device


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, dtype=torch.float32) -> Tensor:
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return (scale * torch.randn((d_in, d_out), generator=generator,
                                device=draw_device(generator))).to(dtype)


def orthogonal_init(generator: torch.Generator, d_in: int, d_out: int,
                    dtype=torch.float32) -> Tensor:
    """Orthonormal-column init: a Stiefel-feasible starting point for
    manifold-constrained weights (the paper initializes on St(d, r))."""
    tall = d_in >= d_out
    a = torch.randn((d_in, d_out) if tall else (d_out, d_in),
                    generator=generator, device=draw_device(generator))
    q = torch.linalg.qr(a)[0]
    return (q if tall else q.T).to(dtype).contiguous()


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Tensor:
    return (torch.randn((vocab, d), generator=generator,
                        device=draw_device(generator)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"]


def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> dict:
    return {"w_gate": dense_init(generator, d, d_ff, dtype=dtype),
            "w_up": dense_init(generator, d, d_ff, dtype=dtype),
            "w_down": dense_init(generator, d_ff, d, dtype=dtype)}


def swiglu(params: dict, x: Tensor) -> Tensor:
    g = torch.nn.functional.silu(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., :, None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# depthwise causal conv (the Mamba2 block's front conv)
# ---------------------------------------------------------------------------


def causal_conv1d_init(generator: torch.Generator, channels: int, width: int,
                       dtype=torch.float32) -> dict:
    return {"w": (torch.randn((width, channels), generator=generator,
                              device=draw_device(generator))
                  * (1.0 / width) ** 0.5).to(dtype)}


def causal_conv1d(params: dict, x: Tensor, state: Tensor | None = None):
    """x: (B, S, C) depthwise causal conv, then SiLU.  With ``state``
    (B, W-1, C), the last W-1 inputs before x, it runs in streaming mode
    and returns (y, new_state).  The sum of shifted products in the JAX
    package's order (not ``F.conv1d``), so the sums round alike."""
    w = params["w"]                        # (W, C)
    width, s = w.shape[0], x.shape[-2]
    if state is None:
        state = x.new_zeros((*x.shape[:-2], width - 1, x.shape[-1]))
        streaming = False
    else:
        streaming = True
    xp = torch.cat([state, x], dim=-2)     # (B, W-1+S, C)
    y = torch.nn.functional.silu(
        sum(xp[..., i:i + s, :] * w[i] for i in range(width)))
    if not streaming:
        return y
    return y, xp[..., xp.shape[-2] - (width - 1):, :]
