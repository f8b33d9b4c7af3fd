"""The gradient of the port's ``flash_attention`` on the CPU.

The JAX package defines no VJP for its Pallas attention; on the CPU it
differentiates its plain ``ref.blockwise_attention``.  The port's
``ops.flash_attention`` carries its gradient in ``torch.autograd.Function``s
(forward and backward, each with a ``vmap`` rule), whose CPU path is
``ref.blockwise_attention`` forward and ``ref.attention_backward``
backward, the plain version of the CUDA backward kernel.  Held here, from
the same NumPy inputs, within 1e-5:

* ``ref.attention_backward`` against ``torch.autograd`` through the port's
  ``ref.blockwise_attention`` and against ``jax.grad`` through the JAX
  package's, over GQA 3:1, causal, a window, S != T, kv positions of -1,
  non-causal, and queries with no usable key (zero output, zero gradient;
  the JAX oracle gives those rows the mean of the values, so there the
  cotangent of those rows is zero);
* the same gradients through ``ops.flash_attention`` under
  ``torch.func.vmap(grad(...))`` over a node axis, with shared (unbatched)
  positions and keys, against ``jax.vmap(jax.grad(...))``;
* the forward under ``vmap`` and ``torch.no_grad`` (the metric's y*), and
  the plumbing: no torch.func tensor reaches the dispatch, the CPU
  launches nothing.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5

# name: (B, S, T, H, Hkv, hd, hdv, causal, window, q offset, empty keys)
CASES = {
    "gqa3_causal": (2, 9, 9, 6, 2, 16, 16, True, None, 0, 0),
    "window": (2, 12, 12, 3, 1, 8, 8, True, 4, 0, 0),
    "s_ne_t": (2, 5, 11, 6, 2, 16, 12, True, None, 6, 0),
    "kv_minus_one": (1, 8, 16, 3, 1, 8, 8, True, None, 8, 5),
    "no_usable_key": (2, 8, 16, 4, 2, 8, 8, True, None, 4, 8),
    "non_causal": (2, 7, 10, 4, 4, 8, 8, False, None, 0, 0),
}


def _inputs(case: str, seed: int = 0, nodes: int | None = None):
    b, s, t, h, hkv, hd, hdv, causal, window, qoff, empty = CASES[case]
    rng = np.random.default_rng(seed)
    lead = () if nodes is None else (nodes,)
    q = rng.normal(size=lead + (b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=lead + (b, t, hkv, hd)).astype(np.float32)
    v = rng.normal(size=lead + (b, t, hkv, hdv)).astype(np.float32)
    w = rng.normal(size=lead + (b, s, h, hdv)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(qoff, qoff + s, dtype=np.int32),
                           (b, s)).copy()
    kpos = np.arange(t, dtype=np.int32)
    kpos = np.broadcast_to(np.where(kpos < empty, -1, kpos), (b, t)).copy()
    kw = dict(causal=causal, window=window)
    # a query row is empty when no key is usable for it
    usable = np.broadcast_to(kpos[:, None, :] >= 0, (b, s, t)).copy()
    if causal:
        usable &= kpos[:, None, :] <= qpos[:, :, None]
    if window is not None:
        usable &= qpos[:, :, None] - kpos[:, None, :] < window
    empty_rows = ~usable.any(-1)                                  # (B, S)
    # cotangent zero on rows without keys (see the module docstring)
    w = w * (~empty_rows)[..., None, None]
    return q, k, v, w, qpos, kpos, kw, empty_rows


def _jax_grads(q, k, v, w, qpos, kpos, kw, nodes: bool = False):
    """jax.grad of sum(blockwise_attention * w) in q, k, v (vmapped over a
    leading node axis of q, k, v and w with ``nodes``), jitted."""
    def f(q, k, v, w):
        out = jref.blockwise_attention(q, k, v, q_positions=qpos,
                                       kv_positions=kpos, **kw)
        return jnp.sum(out * w)
    g = jax.grad(f, argnums=(0, 1, 2))
    g = jax.jit(jax.vmap(g) if nodes else g)
    return [np.asarray(a) for a in g(q, k, v, w)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_and_jax_grad(case):
    q, k, v, w, qpos, kpos, kw, empty_rows = _inputs(case)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = ref.blockwise_attention(tq, tk, tv, q_positions=_t(qpos),
                                  kv_positions=_t(kpos), **kw)
    (out * _t(w)).sum().backward()
    got = ref.attention_backward(_t(q), _t(k), _t(v), out.detach(), _t(w),
                                 q_positions=_t(qpos), kv_positions=_t(kpos),
                                 **kw)
    for g, want in zip(got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
    for g, want in zip(got, _jax_grads(q, k, v, w, qpos, kpos, kw)):
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL)
    if empty_rows.any():
        # rows without keys pass nothing back, whatever their cotangent
        assert not np.any(got[0].numpy()[empty_rows])
        w2 = w + 3.0 * empty_rows[..., None, None]
        again = ref.attention_backward(
            _t(q), _t(k), _t(v), out.detach(), _t(w2), q_positions=_t(qpos),
            kv_positions=_t(kpos), **kw)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vmapped_grad_through_ops_matches_jax(case):
    """vmap(grad) over a node axis of 3, positions shared across nodes."""
    q, k, v, w, qpos, kpos, kw, _ = _inputs(case, seed=1, nodes=3)

    def loss(q, k, v, w):
        return (ops.flash_attention(q, k, v, q_positions=_t(qpos),
                                    kv_positions=_t(kpos), **kw) * w).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(_t(q), _t(k), _t(v), _t(w))

    want = _jax_grads(q, k, v, w, qpos, kpos, kw, nodes=True)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt, rtol=TOL, atol=TOL)


def test_vmap_rule_folds_unbatched_inputs():
    """k and v shared by every node (in_dims None), q batched: the fold
    expands them; the gradient of the shared k and v is each node's."""
    q, k, v, w, qpos, kpos, kw, _ = _inputs("gqa3_causal", seed=2, nodes=2)
    k, v = k[0], v[0]

    def loss(q, k, v, w):
        return (ops.flash_attention(q, k, v, q_positions=_t(qpos),
                                    kv_positions=_t(kpos), **kw) * w).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=(0, None, None, 0))(
        _t(q), _t(k), _t(v), _t(w))
    for i in range(2):
        want = _jax_grads(q[i], k, v, w[i], qpos, kpos, kw)
        for g, wt in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), wt, rtol=TOL, atol=TOL)


def test_forward_under_vmap_and_no_grad():
    q, k, v, _, qpos, kpos, kw, _ = _inputs("window", seed=3, nodes=2)
    with torch.no_grad():
        got = vmap(lambda q, k, v: ops.flash_attention(
            q, k, v, q_positions=_t(qpos), kv_positions=_t(kpos), **kw))(
                _t(q), _t(k), _t(v))
    for i in range(2):
        want = ref.blockwise_attention(_t(q[i]), _t(k[i]), _t(v[i]),
                                       q_positions=_t(qpos),
                                       kv_positions=_t(kpos), **kw)
        assert torch.equal(got[i], want)


def test_plain_autograd_through_ops_and_cpu_launches_nothing():
    q, k, v, w, qpos, kpos, kw, _ = _inputs("s_ne_t", seed=4)
    ops.reset_launch_counts()
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (ops.flash_attention(tq, tk, tv, q_positions=_t(qpos),
                         kv_positions=_t(kpos), **kw) * _t(w)).sum().backward()
    for g, want in zip((tq.grad, tk.grad, tv.grad),
                       _jax_grads(q, k, v, w, qpos, kpos, kw)):
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL)
    assert set(ops.launch_counts().values()) == {0}
    assert ops.backward_launch_counts() == {"flash_attention_bwd": 0}


def test_dispatch_refuses_torch_func_tensors():
    """The kernels take storage: a batched tensor that bypassed the vmap
    rule is refused at the dispatch, on either device."""
    x = torch.zeros(2, 1, 4, 2, 8)
    pos = torch.arange(4, dtype=torch.int32).expand(1, 4)
    with pytest.raises(RuntimeError, match="unfolded"):
        vmap(lambda t: ops._attention_forward(t, t, t, pos, pos, True, 0,
                                              1.0))(x)
    with pytest.raises(RuntimeError, match="unfolded"):
        vmap(lambda t: ops._attention_backward(t, t, t, t, t, pos, pos, True,
                                               0, 1.0, t[..., 0]))(x)


@pytest.mark.parametrize("mode", ["no_grad", "inputs_without_grad",
                                  "requires_grad", "vmap"])
def test_the_function_runs_only_where_there_is_something_to_differentiate(
        mode, monkeypatch):
    """Serving (no grad, no torch.func transform) dispatches directly; a
    gradient or a vmap goes through ``_FlashAttention``; the output is the
    same either way."""
    q, k, v, _, qpos, kpos, kw, _ = _inputs("gqa3_causal", seed=5)
    calls = []
    apply = ops._FlashAttention.apply

    def counted(*args):
        calls.append(1)
        return apply(*args)

    monkeypatch.setattr(ops._FlashAttention, "apply", counted)
    tq, tk, tv = _t(q), _t(k), _t(v)
    pos = dict(q_positions=_t(qpos), kv_positions=_t(kpos), **kw)
    if mode == "no_grad":
        with torch.no_grad():
            tq.requires_grad_()
            got = ops.flash_attention(tq, tk, tv, **pos)
    elif mode == "inputs_without_grad":
        got = ops.flash_attention(tq, tk, tv, **pos)
    elif mode == "requires_grad":
        got = ops.flash_attention(tq.requires_grad_(), tk, tv, **pos)
    else:
        got = vmap(lambda a: ops.flash_attention(a, tk, tv, **pos))(
            tq[None])[0]
    assert bool(calls) == (mode in ("requires_grad", "vmap"))
    want = ref.blockwise_attention(_t(q), tk, tv, **pos)
    assert torch.equal(got.detach(), want)
