"""Public wrappers of the port's kernels, dispatched by tensor device.

  * a tensor on the CPU      -> the plain PyTorch version in ``ref.py``;
  * a tensor on a CUDA card  -> the hand-written CUDA kernel, or an error.

There is no environment switch and no fallback: a CUDA tensor the kernel
does not take (another dtype than float32, or than int8 for a compressed
payload, or than float32/bfloat16 for attention; too many nodes; a head
dim or a Stiefel r above 256) raises, and so does any other device.  The
wrappers own the operand checks, flattening and contiguity, as the JAX
package's ``kernels/ops.py`` does; the kernel modules only allocate,
launch and count (:func:`launch_counts`).  Inside an estimates scope
(``repro_torch.obs.estimates.collect``) every wrapper also records the
call's analytical cost, under the JAX package's kernel name and formula,
on either device: one record per grouped call of up to 16 leaves, the sum
over its leaves.  Outside one it works out no estimate.

``flash_attention`` is differentiable, also under ``torch.func.vmap`` and
``torch.func.grad``: its gradient is the CUDA backward kernel
(``csrc/flash_attention_bwd.cu``) on the card and
``ref.attention_backward`` on the CPU, counted apart
(:func:`backward_launch_counts`), as the kernel has no TPU counterpart.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import leaves as _leaves
from repro_torch.kernels import multi_hop_mix as _mh
from repro_torch.kernels import paged_decode as _pd
from repro_torch.kernels import quant_mix as _qm
from repro_torch.kernels import ref
from repro_torch.kernels import retract as _rt
from repro_torch.kernels import ring_mix as _rm
from repro_torch.kernels import stiefel_project as _sp
from repro_torch.obs import estimates as _est

Tensor = torch.Tensor

# wrapper name -> (launcher module, its launch counter)
_KERNELS = {"stiefel_project": (_sp, "launches"),
            "fused_retract": (_rt, "launches"),
            "ring_mix": (_rm, "launches"),
            "multi_hop_mix": (_mh, "launches"),
            "quant_mix": (_qm, "launches"),
            "multi_hop_mix_quant": (_mh, "quant_launches"),
            "flash_attention": (_fa, "launches"),
            "paged_decode": (_pd, "launches")}
_MAX_GRID_YZ = 65535      # CUDA's limit on grid.y / grid.z
_MAX_HEAD_DIM = 256       # the attention kernels' largest hd / hdv
_MAX_BWD_HEAD_DIM = 128   # the attention backward kernel's
_ATTN_DTYPES = (torch.float32, torch.bfloat16)
# the query block the JAX package's flash-attention estimate reads (its
# DEFAULT_BLOCK_Q; the estimate counts the work of that blocking)
_EST_BLOCK_Q = 128


# kernels without a TPU counterpart, counted apart from launch_counts(),
# whose keys are the JAX package's kernel names (obs/estimates.py KERNELS)
_BACKWARD_KERNELS = {"flash_attention_bwd": (_fa, "bwd_launches")}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNELS.items()}


def backward_launch_counts() -> dict[str, int]:
    """Launches of the backward kernels since the last reset: the
    attention gradient's, two a call (dq, then dk and dv)."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _BACKWARD_KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_KERNELS.values(), *_BACKWARD_KERNELS.values()):
        setattr(mod, attr, 0)


def _record(name: str, leaf_ests) -> None:
    """One :mod:`repro_torch.obs.estimates` record per grouped call: the sum
    of the leaves' estimates (``leaf_ests()``, called only inside a
    ``collect`` scope), for every ``MAX_LEAVES`` leaves."""
    if not _est.collecting():
        return
    ests = leaf_ests()
    for at in range(0, len(ests), _leaves.MAX_LEAVES):
        total = _est.Estimates()
        for e in ests[at:at + _leaves.MAX_LEAVES]:
            total = total + e
        _est.record(name, total)


def _on_card(name: str, *ts: Tensor, dtypes=None) -> bool:
    """False for CPU operands (plain version), True for CUDA operands of
    the kernel's dtypes (``dtypes``, one per operand; float32 by default);
    raises for anything else."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands on different devices "
                         f"{[str(t.device) for t in ts]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t, want in zip(ts, dtypes or [torch.float32] * len(ts)):
        if t.dtype != want:
            raise TypeError(f"{name}: the CUDA kernel takes {want} for this "
                            f"operand, got {t.dtype}")
    return True


def _batched(name: str, x: Tensor, g: Tensor) -> tuple[int, int, int]:
    """(batch, d, r) of matching (..., d, r) operands."""
    if x.shape != g.shape or x.ndim < 2:
        raise ValueError(f"{name}: want matching (..., d, r) operands, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    d, r = x.shape[-2:]
    batch = math.prod(x.shape[:-2])
    if min(batch, d, r) < 1 or batch > _MAX_GRID_YZ:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    return batch, d, r


# ---------------------------------------------------------------------------
# Stiefel tangent projection
# ---------------------------------------------------------------------------


def stiefel_project_leaves(xs: list[Tensor], gs: list[Tensor]
                           ) -> list[Tensor]:
    """P_{T_x}(g) = g - x sym(x^T g) over the last two dims of each pair of
    ``xs`` and ``gs`` (leading dims, the node axis, batched; every leaf on
    one device).  On the card, ONE launch for every 16 leaves whose rows
    fit a cluster's shared memory (``stiefel_project.cluster_size``; the
    fair fc1 and head leaves), two launches for any other leaf; the
    outputs are views of one buffer."""
    name = "stiefel_project"
    if (not isinstance(xs, (list, tuple)) or not xs
            or not isinstance(gs, (list, tuple)) or len(gs) != len(xs)):
        raise ValueError(f"{name}: want equal, non-empty lists of points "
                         f"and directions")
    shapes = [_batched(name, x, g) for x, g in zip(xs, gs)]
    _record(name, lambda: [
        _est.stiefel_project_est(d, r, lead=b, itemsize=x.element_size())
        for (b, d, r), x in zip(shapes, xs)])
    if not _on_card(name, *xs, *gs):
        return [ref.stiefel_project_ref(x, g) for x, g in zip(xs, gs)]
    outs = _sp.launch([x.reshape(s).contiguous() for x, s in zip(xs, shapes)],
                      [g.reshape(s).contiguous() for g, s in zip(gs, shapes)])
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]


def stiefel_project(x: Tensor, g: Tensor) -> Tensor:
    """:func:`stiefel_project_leaves` of one leaf."""
    return stiefel_project_leaves([x], [g])[0]


# ---------------------------------------------------------------------------
# fused polar retraction
# ---------------------------------------------------------------------------


def fused_retract(x: Tensor, g: Tensor, *,
                  ns_iters: int = _rt.DEFAULT_NS_ITERS) -> Tensor:
    """R_x(P_{T_x}(g)) over the last two dims; leading dims (the node axis)
    are batched.  ``g`` is the AMBIENT update direction: the tangent
    projection happens inside the kernel.  The kernel's Gram identity needs
    ``x`` on the manifold (x^T x = I); on the card it takes r up to
    ``retract.MAX_R`` (256)."""
    batch, d, r = _batched("fused_retract", x, g)
    if ns_iters < 0:
        raise ValueError(f"fused_retract: ns_iters={ns_iters} < 0")
    _record("fused_retract", lambda: [_est.fused_retract_est(
        d, r, ns_iters=ns_iters, lead=batch, itemsize=x.element_size())])
    if not _on_card("fused_retract", x, g):
        return ref.fused_retract_ref(x, g, ns_iters=ns_iters)
    if r > _rt.MAX_R:
        raise ValueError(f"fused_retract: the CUDA kernel takes r up to "
                         f"{_rt.MAX_R} (its (r, r) stage in the shared memory "
                         f"of a cluster of 8 CTAs), got r={r}")
    out = _rt.launch(x.reshape(batch, d, r).contiguous(),
                     g.reshape(batch, d, r).contiguous(), ns_iters)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# ring mixes of a node-stacked leaf (node axis 0, neighbours mod n)
# ---------------------------------------------------------------------------


def _nodes(name: str, x: Tensor) -> tuple[int, int]:
    if x.ndim < 1 or x.numel() < 1 or x.shape[0] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: want a node-stacked leaf (n, ...), got "
                         f"{tuple(x.shape)}")
    return x.shape[0], x.numel() // x.shape[0]


def _node_leaves(name: str, xs) -> bool:
    """Checks a list of node-stacked leaves with one node count; then
    :func:`_on_card` over all of them."""
    if not isinstance(xs, (list, tuple)) or not xs:
        raise ValueError(f"{name}: want a non-empty list of node-stacked "
                         f"leaves, got {xs!r}")
    n = _nodes(name, xs[0])[0]
    for x in xs[1:]:
        if _nodes(name, x)[0] != n:
            raise ValueError(f"{name}: leaves of {n} and {x.shape[0]} nodes "
                             f"in one call")
    return _on_card(name, *xs)


def ring_mix_leaves(xs: list[Tensor], *, w_self: float,
                    w_side: float) -> list[Tensor]:
    """One ring hop ``wc*x[i] + ws*(x[i-1] + x[i+1])`` of each node-stacked
    leaf of ``xs`` (neighbours wrapped mod n; every leaf with the same n,
    on one device).  Returns a list of the same shapes.  On the card, ONE
    launch for every 16 leaves (``leaves.MAX_LEAVES``), whose outputs are
    views of one buffer."""
    card = _node_leaves("ring_mix", xs)
    _record("ring_mix", lambda: [
        _est.ring_mix_est(x.numel(), itemsize=x.element_size()) for x in xs])
    if not card:
        return [ref.ring_mix_ref(x, x.roll(1, 0), x.roll(-1, 0), w_self,
                                 w_side) for x in xs]
    return _rm.launch([x.contiguous() for x in xs], w_self, w_side)


def ring_mix(x: Tensor, *, w_self: float, w_side: float) -> Tensor:
    """:func:`ring_mix_leaves` of one leaf."""
    return ring_mix_leaves([x], w_self=w_self, w_side=w_side)[0]


def multi_hop_mix_leaves(xs: list[Tensor], *, hops: int, w_self: float,
                         w_side: float) -> list[Tensor]:
    """``hops`` ring hops of each node-stacked leaf of ``xs``; bitwise
    ``hops`` repeated :func:`ring_mix` calls.  On the card, ONE launch for
    every 16 leaves; the kernel is chosen by n only: a ring of up to 32
    nodes (``multi_hop_mix.MAX_REG_ROWS``) keeps each column in registers,
    a larger one in shared memory.  The plain version is the JAX
    package's halo-panel oracle on the wrapped panel."""
    if hops < 1:
        raise ValueError(f"multi_hop_mix: hops={hops} < 1")
    card = _node_leaves("multi_hop_mix", xs)
    # the JAX package's halo panel: n + 2 hops rows
    _record("multi_hop_mix", lambda: [_est.multi_hop_mix_est(
        x.shape[0] + 2 * hops, x.numel() // x.shape[0], hops=hops,
        out_rows=x.shape[0], itemsize=x.element_size()) for x in xs])
    if not card:
        return [ref.multi_hop_mix_ref(
            ref.ring_panel(x, hops), hops=hops, out_rows=x.shape[0],
            halo=hops, w_self=w_self, w_side=w_side).reshape(x.shape)
            for x in xs]
    return _mh.launch([x.contiguous() for x in xs], hops, w_self, w_side)


def multi_hop_mix(x: Tensor, *, hops: int, w_self: float,
                  w_side: float) -> Tensor:
    """:func:`multi_hop_mix_leaves` of one leaf."""
    return multi_hop_mix_leaves([x], hops=hops, w_self=w_self,
                                w_side=w_side)[0]


# ---------------------------------------------------------------------------
# compressed ring hops on int8 payloads (one fp32 scale per node row)
# ---------------------------------------------------------------------------


def _payload(name: str, q: Tensor, scale: Tensor) -> tuple[int, int, Tensor]:
    """(n, F, scales as (n, 1)) of a node-stacked payload and its scales."""
    n, f = _nodes(name, q)
    if scale.numel() != n:
        raise ValueError(f"{name}: want one scale per node row ({n}), got "
                         f"shape {tuple(scale.shape)}")
    return n, f, scale.reshape(n, 1)


def quant_mix_leaves(qs: list[Tensor], scales: list[Tensor], *,
                     base: list[Tensor] | None = None, w_self: float,
                     w_side: float) -> list[Tensor]:
    """One compressed ring hop ``wc*dq(q[i]) + ws*(dq(q[i-1]) + dq(q[i+1]))``,
    ``dq(q[j]) = q[j] * scale[j]``, of each node-stacked int8 payload of
    ``qs`` with its per-node fp32 scales (``scales``, one tensor of n per
    leaf), neighbours wrapped mod n.  With ``base`` (one fp32 leaf of the
    payload's size per leaf: the old public copies of error feedback), the
    exact ring hop of the base is added: ``(wc*h[i] + ws*(h[i-1] + h[i+1]))
    + that``, bitwise :func:`ring_mix_leaves` of the bases plus the hop
    without a base.  Every leaf has the same n and lies on one device;
    returns fp32 of each payload's shape.  On the card, ONE launch for every
    16 leaves, whose outputs are views of one buffer."""
    name = "quant_mix"
    if (not isinstance(qs, (list, tuple)) or not qs
            or not isinstance(scales, (list, tuple))
            or len(scales) != len(qs)
            or (base is not None and (not isinstance(base, (list, tuple))
                                      or len(base) != len(qs)))):
        raise ValueError(f"{name}: want equal, non-empty lists of payloads, "
                         f"scales and (if given) bases")
    n = _nodes(name, qs[0])[0]
    flat = []
    for q, scale in zip(qs, scales):
        nq, f, s = _payload(name, q, scale)
        if nq != n:
            raise ValueError(f"{name}: leaves of {n} and {nq} nodes in one "
                             f"call")
        flat.append((q.reshape(n, f), s))
    bases = None
    if base is not None:
        bases = []
        for b, (q2, _) in zip(base, flat):
            if b.ndim < 1 or b.shape[0] != n or b.numel() != q2.numel():
                raise ValueError(f"{name}: want a base of {n} nodes and "
                                 f"{q2.numel()} elements, got shape "
                                 f"{tuple(b.shape)}")
            bases.append(b.reshape(n, -1))
    # the int8 hop of each leaf, as the JAX package counts it; its exact hop
    # of the base is a roll there, which records nothing
    _record(name, lambda: [_est.quant_mix_est(n, q2.shape[1])
                           for q2, _ in flat])
    card = _on_card(name, *(q for q, _ in flat), *(s for _, s in flat),
                    *(bases or ()),
                    dtypes=(torch.int8,) * len(flat)
                    + (torch.float32,) * (len(flat) + len(bases or ())))
    if not card:
        outs = [ref.quant_mix_ref(q2, q2.roll(1, 0), q2.roll(-1, 0), s,
                                  s.roll(1, 0), s.roll(-1, 0), w_self, w_side)
                for q2, s in flat]
        if bases is not None:
            outs = [ref.ring_mix_ref(b, b.roll(1, 0), b.roll(-1, 0), w_self,
                                     w_side) + o for b, o in zip(bases, outs)]
    else:
        outs = _qm.launch([q2.contiguous() for q2, _ in flat],
                          [s.contiguous() for _, s in flat],
                          None if bases is None
                          else [b.contiguous() for b in bases],
                          w_self, w_side)
    return [o.reshape(q.shape) for o, q in zip(outs, qs)]


def quant_mix(q: Tensor, scale: Tensor, *, w_self: float,
              w_side: float) -> Tensor:
    """:func:`quant_mix_leaves` of one leaf, without a base."""
    return quant_mix_leaves([q], [scale], w_self=w_self, w_side=w_side)[0]


def multi_hop_mix_quant_leaves(qs: list[Tensor], scales: list[Tensor], *,
                               hops: int, w_self: float,
                               w_side: float) -> list[Tensor]:
    """``hops`` int8-compressed ring hops of each node-stacked int8 payload
    of ``qs`` with its per-node fp32 scales (``scales``, one tensor of n
    per leaf): hop 0 decodes and combines the payload (:func:`quant_mix`),
    every later hop requantizes each row deterministically
    (``comms.compress.quantize_det``) and combines the decoded values.
    Every leaf has the same n and lies on one device; returns fp32 of each
    payload's shape.  On the card, ONE launch for every 16 leaves, with one
    barrier a hop for all of them; each (leaf, row) keeps its own scale,
    so every leaf's result is bitwise a launch of its own.  The plain
    version is the JAX package's halo-panel oracle on the wrapped panel,
    center rows."""
    name = "multi_hop_mix_quant"
    if hops < 1:
        raise ValueError(f"{name}: hops={hops} < 1")
    if (not isinstance(qs, (list, tuple)) or not qs
            or not isinstance(scales, (list, tuple))
            or len(scales) != len(qs)):
        raise ValueError(f"{name}: want equal, non-empty lists of payloads "
                         f"and scales")
    n = _nodes(name, qs[0])[0]
    flat = []
    for q, scale in zip(qs, scales):
        nq, f, s = _payload(name, q, scale)
        if nq != n:
            raise ValueError(f"{name}: leaves of {n} and {nq} nodes in one "
                             f"call")
        flat.append((q.reshape(n, f), s))
    _record(name, lambda: [
        _est.multi_hop_mix_est(n + 2 * hops, q2.shape[1], hops=hops,
                               out_rows=n, quant=True) for q2, _ in flat])
    if not _on_card(name, *(q for q, _ in flat), *(s for _, s in flat),
                    dtypes=(torch.int8,) * len(flat)
                    + (torch.float32,) * len(flat)):
        outs = []
        for q2, s in flat:
            z = ref.multi_hop_mix_quant_ref(
                ref.ring_panel(q2, hops), ref.ring_panel(s, hops), hops=hops,
                w_self=w_self, w_side=w_side)
            outs.append(z[hops:hops + n])
    else:
        outs = _mh.launch_quant([q2.contiguous() for q2, _ in flat],
                                [s.contiguous() for _, s in flat], hops,
                                w_self, w_side)
    return [o.reshape(q.shape) for o, q in zip(outs, qs)]


def multi_hop_mix_quant(q: Tensor, scale: Tensor, *, hops: int,
                        w_self: float, w_side: float) -> Tensor:
    """:func:`multi_hop_mix_quant_leaves` of one leaf."""
    return multi_hop_mix_quant_leaves([q], [scale], hops=hops, w_self=w_self,
                                      w_side=w_side)[0]


# ---------------------------------------------------------------------------
# attention: q (B, S, H, hd), k/v (B, T, Hkv, hd/hdv), the JAX layout
# ---------------------------------------------------------------------------


def _attn_card(name: str, q: Tensor, floats: tuple, ints: tuple) -> bool:
    """:func:`_on_card` for attention: the float operands in q's dtype,
    float32 or bfloat16, the index operands int32."""
    dtypes = (q.dtype,) * len(floats) + (torch.int32,) * len(ints)
    if not _on_card(name, *floats, *ints, dtypes=dtypes):
        return False
    if q.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    return True


def _head_dims(name: str, hd: int, hdv: int) -> None:
    if max(hd, hdv) > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dims up to "
                         f"{_MAX_HEAD_DIM}, got hd={hd}, hdv={hdv}")


def _window(name: str, window: int | None) -> int:
    if window is not None and window < 1:
        raise ValueError(f"{name}: window={window} < 1")
    return window or 0


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None,
                    q_positions: Tensor | None = None,
                    kv_positions: Tensor | None = None,
                    softmax_scale: float | None = None) -> Tensor:
    """Attention of q (B, S, H, hd) over k (B, T, Hkv, hd) and v
    (B, T, Hkv, hdv); returns (B, S, H, hdv) in q's dtype.

    Query head h reads kv head ``h // (H // Hkv)``.  Positions (B, S) and
    (B, T) default to aranges; a key is usable when its position is >= 0,
    and, when ``causal``, <= the query's, and, with a ``window``, less than
    ``window`` behind it.  A query with no usable key gets exact zeros.

    Differentiable in q, k and v (:class:`_FlashAttention`), under
    ``torch.func.vmap`` and ``grad`` too: the backward kernel on the card
    takes float32 only and raises a TypeError for bf16.  With nothing to
    differentiate or fold (serving: no grad, no ``torch.func`` transform)
    it dispatches directly: through ``Function.apply`` a prefill call
    cost the host of an H100 machine 70-130 us more
    (``launch/serve_timing.py``)."""
    b, s, h, hd = q.shape
    t, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape != (b, t, hkv, hd) or v.shape[:3] != (b, t, hkv)
            or h % hkv):
        raise ValueError(f"flash_attention: want q (B, S, H, hd), k "
                         f"(B, T, Hkv, hd), v (B, T, Hkv, hdv) with Hkv | H; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    win = _window("flash_attention", window)
    if q_positions is None:
        q_positions = torch.arange(s, dtype=torch.int32, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(t, dtype=torch.int32, device=q.device)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    _record("flash_attention", lambda: [_est.flash_attention_est(
        b, s, t, h, hd, causal=causal, window=window, block_q=_EST_BLOCK_Q,
        itemsize=q.element_size())])
    args = (q, k, v, q_positions.expand(b, s), kv_positions.expand(b, t),
            causal, win, scale)
    if torch._C._are_functorch_transforms_active() or (
            torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashAttention.apply(*args)
    return _attention_forward(*args)


def flash_attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                             d_out: Tensor, *, causal: bool = True,
                             window: int | None = None,
                             q_positions: Tensor | None = None,
                             kv_positions: Tensor | None = None,
                             softmax_scale: float | None = None
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of ``out = flash_attention(q, k, v, ...)`` for the
    cotangent ``d_out`` (B, S, H, hdv): what the gradient of
    :func:`flash_attention` runs, called directly (not differentiable).
    The CUDA backward kernel on the card (float32 only; head dims up to
    128), ``ref.attention_backward`` on the CPU."""
    b, s = q.shape[:2]
    t = k.shape[1]
    if out.shape != d_out.shape or out.shape[:3] != q.shape[:3]:
        raise ValueError(f"flash_attention_backward: want out and d_out "
                         f"(B, S, H, hdv) of q's (B, S, H); got "
                         f"{tuple(out.shape)}, {tuple(d_out.shape)}")
    if q_positions is None:
        q_positions = torch.arange(s, dtype=torch.int32, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(t, dtype=torch.int32, device=q.device)
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    return _attention_backward(d_out, q, k, v, out, q_positions.expand(b, s),
                               kv_positions.expand(b, t), causal,
                               _window("flash_attention_backward", window),
                               scale)


def _plain_operands(name: str, *ts: Tensor) -> None:
    """A kernel takes storage: the ``vmap`` rules below fold every
    ``torch.func`` level into the batch axis before the dispatch."""
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in ts):
        raise RuntimeError(f"{name}: a torch.func tensor reached the "
                           f"dispatch unfolded")


def _attention_forward(q, k, v, q_pos, kv_pos, causal, window, scale):
    """The forward on plain tensors: the CUDA kernel on the card, the plain
    version on the CPU."""
    _plain_operands("flash_attention", q, k, v, q_pos, kv_pos)
    if not _attn_card("flash_attention", q, (q, k, v), (q_pos, kv_pos)):
        return ref.blockwise_attention(
            q, k, v, causal=causal, window=window or None,
            q_positions=q_pos, kv_positions=kv_pos, softmax_scale=scale)
    b, s, h, hd = q.shape
    _head_dims("flash_attention", hd, v.shape[-1])
    if min(b, s, h) < 1 or max(b, h) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: unsupported shape "
                         f"{tuple(q.shape)}")
    return _fa.launch(q.contiguous(), k.contiguous(), v.contiguous(),
                      q_pos.contiguous(), kv_pos.contiguous(), causal=causal,
                      window=window, scale=scale)


def _attention_backward(d_out, q, k, v, out, q_pos, kv_pos, causal, window,
                        scale):
    """(dq, dk, dv) on plain tensors: the CUDA backward kernel on the card
    (float32 only), ``ref.attention_backward`` on the CPU."""
    _plain_operands("flash_attention backward", d_out, q, k, v, out, q_pos,
                    kv_pos)
    if not _attn_card("flash_attention backward", q, (q, k, v, out, d_out),
                      (q_pos, kv_pos)):
        return ref.attention_backward(
            q, k, v, out, d_out, causal=causal, window=window or None,
            q_positions=q_pos, kv_positions=kv_pos, softmax_scale=scale)
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention backward: the CUDA kernel takes "
                        f"float32 only, got {q.dtype}")
    b, s, h, hd = q.shape
    hdv = v.shape[-1]
    if max(hd, hdv) > _MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention backward: the CUDA kernel takes "
                         f"head dims up to {_MAX_BWD_HEAD_DIM}, got hd={hd}, "
                         f"hdv={hdv}")
    if min(b, s, h, k.shape[1]) < 1 or max(b, h) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention backward: unsupported shape "
                         f"{tuple(q.shape)}")
    return _fa.launch_backward(q.contiguous(), k.contiguous(), v.contiguous(),
                               out.contiguous(), d_out.contiguous(),
                               q_pos.contiguous(), kv_pos.contiguous(),
                               causal=causal, window=window, scale=scale)


def _fold(x: Tensor, dim: int | None, n: int) -> Tensor:
    """A ``vmap`` level folded into the batch axis: the vmapped dim (or an
    expanded copy where the input is not batched) moved first, then
    (n, B, ...) -> (n * B, ...)."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:])


class _FlashAttention(torch.autograd.Function):
    """flash_attention as an autograd Function that ``torch.func`` accepts:
    ``forward`` without ctx, ``setup_context``, and a ``vmap`` rule that
    folds the vmapped axis into B, so the kernel sees plain tensors."""

    @staticmethod
    def forward(q, k, v, q_pos, kv_pos, causal, window, scale):
        return _attention_forward(q, k, v, q_pos, kv_pos, causal, window,
                                  scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, kv_pos, causal, window, scale = inputs
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, output)
        ctx.args = (causal, window, scale)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, q_pos, kv_pos, out = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBackward.apply(d_out, q, k, v, out, q_pos,
                                                   kv_pos, *ctx.args)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, kv_pos, causal, window, scale):
        n = info.batch_size
        folded = [_fold(x, d, n)
                  for x, d in zip((q, k, v, q_pos, kv_pos), in_dims[:5])]
        out = _FlashAttention.apply(*folded, causal, window, scale)
        return out.unflatten(0, (n, -1)), 0


class _FlashAttentionBackward(torch.autograd.Function):
    """The attention gradient as a Function of its own, so that the
    backward too gets a ``vmap`` rule: under ``vmap(grad(...))`` it
    receives batched tensors, which no kernel can take."""

    @staticmethod
    def forward(d_out, q, k, v, out, q_pos, kv_pos, causal, window, scale):
        return _attention_backward(d_out, q, k, v, out, q_pos, kv_pos, causal,
                                   window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, d_out, q, k, v, out, q_pos, kv_pos, causal,
             window, scale):
        n = info.batch_size
        folded = [_fold(x, d, n) for x, d in
                  zip((d_out, q, k, v, out, q_pos, kv_pos), in_dims[:7])]
        grads = _FlashAttentionBackward.apply(*folded, causal, window, scale)
        return tuple(g.unflatten(0, (n, -1)) for g in grads), (0, 0, 0)


def paged_decode_attention(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                           block_table: Tensor, seq_lens: Tensor, *,
                           window: int | None = None,
                           softmax_scale: float | None = None) -> Tensor:
    """One decode token per slot over a paged KV pool.

    q (S, H, hd); pools (P, page_size, Hkv, hd/hdv); block_table (S, M)
    int32 (-1 = unallocated, read as the dump page 0 and masked); seq_lens
    (S,) int32, the valid tokens with the query at ``seq_lens - 1``.
    Returns (S, H, hdv); a slot with ``seq_lens == 0`` gets exact zeros."""
    s_slots, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    hdv = v_pages.shape[-1]
    if (k_pages.shape[3] != hd or v_pages.shape[:3] != k_pages.shape[:3]
            or h % hkv or block_table.ndim != 2
            or block_table.shape[0] != s_slots
            or seq_lens.shape != (s_slots,)):
        raise ValueError(
            f"paged_decode_attention: want q (S, H, hd), pools "
            f"(P, ps, Hkv, hd/hdv) with Hkv | H, block_table (S, M), "
            f"seq_lens (S,); got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}, {tuple(block_table.shape)}, "
            f"{tuple(seq_lens.shape)}")
    win = _window("paged_decode_attention", window)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    _record("paged_decode", lambda: [_est.paged_decode_est(
        s_slots, h, hkv, hd, block_table.shape[1], ps,
        itemsize=q.element_size())])
    if not _attn_card("paged_decode_attention", q, (q, k_pages, v_pages),
                      (block_table, seq_lens)):
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_table, seq_lens, window=window,
            softmax_scale=scale)
    _head_dims("paged_decode_attention", hd, hdv)
    if s_slots < 1 or s_slots > _MAX_GRID_YZ:
        raise ValueError(f"paged_decode_attention: unsupported slot count "
                         f"{s_slots}")
    return _pd.launch(q.contiguous(), k_pages.contiguous(),
                      v_pages.contiguous(), block_table.contiguous(),
                      seq_lens.contiguous(), window=win, scale=scale)
