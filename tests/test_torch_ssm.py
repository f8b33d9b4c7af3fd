"""The port's Mamba2 block (``repro_torch.models.ssm``) and its causal
convolution (``models.layers.causal_conv1d``) against the JAX package on
the CPU, from NumPy inputs.

Tolerances: the causal convolution within 1e-6 absolute (the same sum of
shifted products, in the same order); the SSD core (``_ssd_chunked``,
``ssd_reference``) within 1e-5 of the largest |value| of the JAX
functions' (fp32 einsums summed in another order, over terms that
cancel), and chunked against sequential within the JAX test's own 1e-4
(``tests/test_models.py``); the gates within 1e-6 absolute and
relative (``exp`` rounds an ulp apart); ``mamba_prefill`` outputs and caches
and ``mamba_decode`` steps within 1e-5 of the JAX block from its own
initial weights, at ``n_groups`` 1 and 2 (only a group count above 1
tells ``repeat_interleave`` from ``Tensor.repeat``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SSMSpec as JSSMSpec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import ModelConfig, SSMSpec  # noqa: E402
from repro_torch.convert import tree_from_reference  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


# the JAX block's entry points, jitted (faster than op by op on the CPU)
_jprefill = jax.jit(jssm.mamba_prefill, static_argnums=(2, 3),
                    static_argnames=("make_cache",))
_jdecode = jax.jit(jssm.mamba_decode, static_argnums=(2, 3))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _close_scaled(got, want, tol):
    """Within ``tol`` times the largest |value| of ``want``."""
    want = np.asarray(want)
    _close(got, want, tol * float(np.abs(want).max()))


def _ssd_inputs(shape=(2, 100, 4, 16, 8), seed=0):
    """(x, B, C, dt, log decay) as the JAX test draws them, from NumPy:
    dt a softplus, the log decay ``-dt * exp(0.5 N(0, 1))``."""
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    b_ = rng.standard_normal((b, s, h, n), dtype=np.float32)
    c_ = rng.standard_normal((b, s, h, n), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    la = (-dt * np.exp(0.5 * rng.standard_normal((b, s, h)))).astype(
        np.float32)
    return x, b_, c_, dt, la


@pytest.mark.parametrize("streaming", [False, True])
def test_causal_conv1d_matches_reference(streaming):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 24), dtype=np.float32) * 0.5
    x = rng.standard_normal((3, 11, 24), dtype=np.float32)
    state = rng.standard_normal((3, 3, 24), dtype=np.float32)
    params = {"w": torch.from_numpy(w)}
    if streaming:
        want, wstate = jlayers.causal_conv1d({"w": jnp.asarray(w)},
                                             jnp.asarray(x),
                                             jnp.asarray(state))
        got, gstate = layers.causal_conv1d(params, torch.from_numpy(x),
                                           torch.from_numpy(state))
        _close(gstate, wstate, 0.0)
        # streaming one token at a time equals the whole sequence
        st = torch.from_numpy(state)
        steps = []
        for t in range(x.shape[1]):
            y, st = layers.causal_conv1d(
                params, torch.from_numpy(x[:, t:t + 1]), st)
            steps.append(y)
        _close(torch.cat(steps, 1), got, 1e-6)
    else:
        want = jlayers.causal_conv1d({"w": jnp.asarray(w)}, jnp.asarray(x))
        got = layers.causal_conv1d(params, torch.from_numpy(x))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("shape, chunk", [((2, 100, 4, 16, 8), 32),
                                          ((1, 64, 2, 8, 4), 64),
                                          ((2, 7, 3, 4, 5), 256)])
def test_ssd_pair_matches_reference(shape, chunk):
    """Both SSD functions against the JAX package's (a length that is not
    a multiple of the chunk pads the last chunk; a chunk above the length
    is cut to it), and chunked against sequential (1e-4)."""
    args = _ssd_inputs(shape)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    ry, rh = jssm.ssd_reference(*map(jnp.asarray, args))
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)
    y0, h0 = ssm.ssd_reference(*map(torch.from_numpy, args))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == shape[:4] and \
        tuple(h.shape) == (shape[0], shape[2], shape[4], shape[3])
    _close_scaled(y, jy, 1e-5)
    _close_scaled(h, jh, 1e-5)
    _close_scaled(y0, ry, 1e-5)
    _close_scaled(h0, rh, 1e-5)
    _close(y, y0, 1e-4)
    _close(h, h0, 1e-4)


def test_ssd_gradient_is_finite_through_the_mask():
    """The mask sits inside the exponential: the gradient of a loss
    through ``_ssd_chunked`` is finite, and equals the sequential
    oracle's (1e-4)."""
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _ssd_inputs((1, 40, 2, 4, 3), seed=3)]
    y, h = ssm._ssd_chunked(*args, 16)
    grads = torch.autograd.grad(y.square().sum() + h.sum(), args)
    y0, h0 = ssm.ssd_reference(*args)
    want = torch.autograd.grad(y0.square().sum() + h0.sum(), args)
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        _close(g.detach(), w.detach(), 1e-4 * float(w.abs().max()))


def _block(n_groups: int):
    jspec = JSSMSpec(d_state=8, head_dim=16, chunk=16, n_groups=n_groups)
    jcfg = JModelConfig(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab_size=97)
    spec = SSMSpec(d_state=8, head_dim=16, chunk=16, n_groups=n_groups)
    cfg = ModelConfig(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab_size=97)
    jparams = jssm.init_mamba(jax.random.PRNGKey(n_groups), jcfg, jspec)
    # a_log at its init is the same on both sides; move d_skip and dt_bias
    # off their ones and zeros so they count
    rng = np.random.default_rng(n_groups)
    jparams = dict(jparams)
    for name in ("d_skip", "dt_bias"):
        jparams[name] = jnp.asarray(
            rng.standard_normal(jparams[name].shape, dtype=np.float32))
    return (jcfg, jspec, jparams), (cfg, spec,
                                    tree_from_reference(jparams, "cpu",
                                                        np.float32))


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba_prefill_and_decode_match_reference(n_groups):
    """The block's prefill (37 tokens: three chunks of 16, the last
    padded) with its cache, then 4 decode steps on each side's own cache:
    outputs and the final ``{ssm, conv}`` state within 1e-5; the decode
    writes the port's cache in place."""
    (jcfg, jspec, jp), (cfg, spec, p) = _block(n_groups)
    rng = np.random.default_rng(10 + n_groups)
    u = rng.standard_normal((2, 37, 64), dtype=np.float32)
    steps = rng.standard_normal((4, 2, 1, 64), dtype=np.float32)
    jy, jcache = _jprefill(jp, jnp.asarray(u), jcfg, jspec, make_cache=True)
    y, cache = ssm.mamba_prefill(p, torch.from_numpy(u), cfg, spec,
                                 make_cache=True)
    _close(y, jy, 1e-5)
    y_nc, none = ssm.mamba_prefill(p, torch.from_numpy(u), cfg, spec)
    assert none is None
    _close(y_nc, y, 0.0)
    for name in ("ssm", "conv"):
        _close(cache[name], jcache[name], 1e-5)
    held = {k: v for k, v in cache.items()}
    for t in range(4):
        jy, jcache = _jdecode(jp, jnp.asarray(steps[t]), jcfg, jspec,
                              jcache)
        y, cache = ssm.mamba_decode(p, torch.from_numpy(steps[t]), cfg,
                                    spec, cache)
        _close(y, jy, 1e-5)
    assert all(cache[k] is held[k] for k in held)
    for name in ("ssm", "conv"):
        _close(cache[name], jcache[name], 1e-5)
    empty = ssm.init_mamba_cache(cfg, spec, 2)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in cache.items()}
    assert empty["ssm"].dtype == torch.float32


@pytest.mark.parametrize("n_groups", [1, 2])
def test_gates_repeat_each_group_over_its_heads(n_groups):
    """B and C of group g serve heads g * H/G .. (g+1) * H/G - 1, as
    ``jnp.repeat`` lays them out; dt and the log decay within 1e-6
    absolute and relative."""
    (jcfg, jspec, jp), (cfg, spec, p) = _block(n_groups)
    rng = np.random.default_rng(20)
    d_inner = 2 * 64
    xbc = rng.standard_normal((2, 5, d_inner + 2 * n_groups * 8),
                              dtype=np.float32)
    dt_raw = rng.standard_normal((2, 5, d_inner // 16), dtype=np.float32)
    want = jssm._gates(jp, jnp.asarray(xbc), jnp.asarray(dt_raw), jcfg, jspec)
    got = ssm._gates(p, torch.from_numpy(xbc), torch.from_numpy(dt_raw), cfg,
                     spec)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-6)
