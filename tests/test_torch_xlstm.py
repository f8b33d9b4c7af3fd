"""The port's xLSTM cells (``repro_torch.models.xlstm``) against the JAX
package on the CPU, from NumPy inputs.

Tolerances: every function within 1e-5 of the largest |value| of the
JAX function's output (fp32 einsums summed in another order; the mLSTM's
normalizer ``max(|q.n|, exp(-m))`` divides by small numbers and carries
the rounding to about 6e-7 of the largest |y| here); the chunked form
against the recurrence within the JAX test's own 2e-3
(``tests/test_models.py``); the gradient of a loss through
``_mlstm_chunked`` under ``torch.func.vmap(grad)`` finite and within 1e-5
of the largest |value| of ``jax.vmap(jax.grad)``'s.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import XLSTMSpec as JXLSTMSpec  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs.base import ModelConfig, XLSTMSpec  # noqa: E402
from repro_torch.convert import tree_from_reference  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5
# the JAX cells' entry points, jitted (faster than op by op on the CPU)
_jm_prefill = jax.jit(jxlstm.mlstm_prefill, static_argnums=(2, 3),
                      static_argnames=("make_cache",))
_jm_decode = jax.jit(jxlstm.mlstm_decode, static_argnums=(2, 3))
_js_prefill = jax.jit(jxlstm.slstm_prefill, static_argnums=(2, 3),
                      static_argnames=("make_cache",))
_js_decode = jax.jit(jxlstm.slstm_decode, static_argnums=(2, 3))


def _close_scaled(got, want, tol=TOL):
    """Within ``tol`` times the largest |value| of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _mlstm_inputs(shape=(2, 72, 2, 8), seed=3):
    """(q, k, v, li, lf) as the JAX test draws them, from NumPy: li
    2 N(0, 1), lf the log-sigmoid of N(0, 1) + 2."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    li = (2.0 * rng.standard_normal((b, s, h))).astype(np.float32)
    lf = (-np.logaddexp(0.0, -(rng.standard_normal((b, s, h)) + 2.0))
          ).astype(np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("shape, chunk", [((2, 72, 2, 8), 16),
                                          ((1, 40, 4, 8), 64),
                                          ((2, 33, 3, 5), 8)])
def test_mlstm_pair_matches_reference(shape, chunk):
    """``_mlstm_chunked`` (72 tokens in chunks of 16: the last one padded;
    a chunk above the length is cut to it) and ``mlstm_reference``
    against the JAX package's, output and final (C, n, m) state; the
    chunked form against the recurrence within the JAX test's 2e-3."""
    args = _mlstm_inputs(shape)
    jy, jstate = jax.jit(jxlstm._mlstm_chunked, static_argnums=(5,))(
        *map(jnp.asarray, args), chunk)
    ry, rstate = jax.jit(jxlstm.mlstm_reference)(*map(jnp.asarray, args))
    y, state = xlstm._mlstm_chunked(*map(torch.from_numpy, args), chunk)
    y0, state0 = xlstm.mlstm_reference(*map(torch.from_numpy, args))
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    b, _, h, d = shape
    assert [tuple(t.shape) for t in state] == [(b, h, d, d), (b, h, d),
                                              (b, h)]
    _close_scaled(y, jy)
    _close_scaled(y0, ry)
    for got, want in zip((*state, *state0), (*jstate, *rstate)):
        _close_scaled(got, want)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=2e-3, rtol=0)


def test_mlstm_gradient_under_vmap_matches_reference():
    """``torch.func.vmap(grad)`` of a loss through ``_mlstm_chunked`` (the
    trainer's transform, over a node axis of 3): finite, and within 1e-5
    of the largest |value| of ``jax.vmap(jax.grad)``'s, for every input.
    The mask sits inside the exponential, so no masked entry meets
    inf * 0."""
    nodes = [_mlstm_inputs((1, 40, 2, 4), seed=s) for s in (5, 6, 7)]
    stacked = [np.stack(parts) for parts in zip(*nodes)]

    def jloss(q, k, v, li, lf):
        y, (c, n, m) = jxlstm._mlstm_chunked(q, k, v, li, lf, 16)
        return jnp.sum(y ** 2) + jnp.sum(c) + jnp.sum(n)

    def loss(q, k, v, li, lf):
        y, (c, n, m) = xlstm._mlstm_chunked(q, k, v, li, lf, 16)
        return y.square().sum() + c.sum() + n.sum()

    want = jax.jit(jax.vmap(jax.grad(jloss, argnums=(0, 1, 2, 3, 4))))(
        *map(jnp.asarray, stacked))
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *map(torch.from_numpy, stacked))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close_scaled(g, w)


def _cfg(jax_side: bool):
    cls, spec = ((JModelConfig, JXLSTMSpec) if jax_side
                 else (ModelConfig, XLSTMSpec))
    return (cls(d_model=32, n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=97),
            spec(proj_factor=2.0, conv_window=4, chunk=16))


def _cells(kind: str):
    """(JAX cfg, spec, params), (port cfg, spec, params): the JAX cell's
    initial weights, carried over leaf for leaf."""
    jcfg, jspec = _cfg(True)
    cfg, spec = _cfg(False)
    init = jxlstm.init_mlstm if kind == "mlstm" else jxlstm.init_slstm
    jparams = init(jax.random.PRNGKey(1), jcfg, jspec)
    return (jcfg, jspec, jparams), (cfg, spec,
                                    tree_from_reference(jparams, "cpu",
                                                        np.float32))


def _flat(cache: dict) -> dict:
    """{name: array} of a cell's cache (the sLSTM state's four parts as
    state0..state3)."""
    out = {}
    for name, value in cache.items():
        if isinstance(value, tuple):
            out.update({f"{name}{i}": v for i, v in enumerate(value)})
        else:
            out[name] = value
    return out


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_prefill_and_decode_match_reference(kind):
    """The cell's prefill (37 tokens: for the mLSTM three chunks of 16,
    the last padded) with its cache, then 4 decode steps on each side's
    own cache (the mLSTM's conv state streamed): outputs and every part
    of the final cache within 1e-5 of the largest |value|; the prefill
    without a cache gives the same output; the decode writes the port's
    cache in place; the empty cache has the cache's shapes, fp32."""
    (jcfg, jspec, jp), (cfg, spec, p) = _cells(kind)
    jpre, jdec = ((_jm_prefill, _jm_decode) if kind == "mlstm"
                  else (_js_prefill, _js_decode))
    pre, dec = ((xlstm.mlstm_prefill, xlstm.mlstm_decode) if kind == "mlstm"
                else (xlstm.slstm_prefill, xlstm.slstm_decode))
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, 37, 32), dtype=np.float32)
    steps = rng.standard_normal((4, 2, 1, 32), dtype=np.float32)
    jy, jcache = jpre(jp, jnp.asarray(u), jcfg, jspec, make_cache=True)
    y, cache = pre(p, torch.from_numpy(u), cfg, spec, make_cache=True)
    _close_scaled(y, jy)
    y_nc, none = pre(p, torch.from_numpy(u), cfg, spec)
    assert none is None
    np.testing.assert_array_equal(y_nc.numpy(), y.numpy())
    for name, value in _flat(cache).items():
        _close_scaled(value, _flat(jcache)[name])
    held = _flat(cache)
    for t in range(4):
        jy, jcache = jdec(jp, jnp.asarray(steps[t]), jcfg, jspec, jcache)
        y, cache = dec(p, torch.from_numpy(steps[t]), cfg, spec, cache)
        _close_scaled(y, jy)
    assert all(_flat(cache)[k] is v for k, v in held.items())
    for name, value in _flat(cache).items():
        _close_scaled(value, _flat(jcache)[name])
    empty = (xlstm.init_mlstm_cache(cfg, spec, 2) if kind == "mlstm"
             else xlstm.init_slstm_cache(cfg, 2))
    assert {k: (tuple(v.shape), v.dtype) for k, v in _flat(empty).items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in held.items()}


def test_mlstm_inputs_come_from_their_paths():
    """v from the unconvolved path, q, k and the gates from the convolved
    one, k scaled by dk^-1/2, the gates fp32: the projections of
    ``_mlstm_qkvif`` within 1e-5 of the largest |value| of the JAX
    package's, and v unchanged when the conv kernel changes."""
    (jcfg, jspec, jp), (cfg, spec, p) = _cells("mlstm")
    u = np.random.default_rng(12).standard_normal((2, 9, 32),
                                                  dtype=np.float32)
    want = jxlstm._mlstm_qkvif(jp, jnp.asarray(u), jcfg, jspec)
    got = xlstm._mlstm_qkvif(p, torch.from_numpy(u), cfg, spec)
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == torch.float32
        _close_scaled(g, w)
    p2 = {**p, "conv": {"w": p["conv"]["w"] * 2.0}}
    moved = xlstm._mlstm_qkvif(p2, torch.from_numpy(u), cfg, spec)
    assert torch.equal(moved[2], got[2])
    assert not torch.equal(moved[0], got[0])
