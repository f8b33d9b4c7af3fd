"""Shared checks of the port's served architectures against the JAX
package at ``SMOKE``: the JAX initial weights carried over with
``repro_torch.convert``, the same NumPy prompts on both sides.  Imported
by ``tests/test_torch_models_*.py`` after ``pytest.importorskip("jax")``.

Tolerances: logits, caches and the MoE auxiliary loss within 1e-5
absolute (fp32 products, norms and softmax summed in another order
through two layers); greedy tokens exactly.  A model with a frontend
takes the same NumPy embeddings on both sides (:func:`frontend`).
"""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.launch.serve import generate as jgenerate
from repro.models import transformer as JT
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import PagedKVSpec as JSpec
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import serve_requests as jserve
from repro_torch import configs, convert
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.serve import (ContinuousBatchingScheduler, PagedKVSpec,
                               Request, ServeEngine, serve_requests)
from repro_torch.tree import tree_flatten_with_path

TOL = 1e-5
# the JAX model's entry points, jitted (faster than op by op on the CPU)
_jforward = jax.jit(JT.forward, static_argnums=(1,),
                    static_argnames=("mode", "cache_len"))
_jdecode = jax.jit(JT.decode_step, static_argnums=(1,))


def carried(arch: str) -> tuple:
    """(jcfg, jparams, cfg, params): both ``SMOKE`` configs and the JAX
    package's initial weights (``PRNGKey(0)``) on both sides."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_config(arch, smoke=True)
    return jcfg, jparams, cfg, convert.transformer_params_from_reference(
        jparams, "cpu")


def prompts(cfg, batch: int, length: int, seed: int) -> np.ndarray:
    """(B, S) tokens, or (B, S, CB) with codebooks, from a seed."""
    shape = (batch, length) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                               else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def frontend(cfg, batch: int, seed: int) -> np.ndarray | None:
    """(B, n_tokens, embed_dim) frontend embeddings from a seed
    (``convert.lm_frontend_from_seed``); None without a frontend."""
    if cfg.frontend is None:
        return None
    return convert.lm_frontend_from_seed(cfg, 1, batch, seed)[0]


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def ragged(cfg, lengths, seed: int) -> list:
    """One prompt (a token list) per length, from a seed."""
    return [prompts(cfg, 1, n, seed + i)[0].tolist()
            for i, n in enumerate(lengths)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def check_parameter_trees(model) -> None:
    """The JAX tree carried over and back is bitwise itself;
    ``abstract_params`` and ``lm_params_from_seed`` have its paths and
    shapes."""
    jcfg, jparams, cfg, params = model
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]}
    paths, back, _ = tree_flatten_with_path(
        convert.transformer_params_to_reference(params))
    assert set(paths) == set(want)
    for p, a in zip(paths, back):
        np.testing.assert_array_equal(a, want[p], err_msg=p)
    shapes = {p: v.shape for p, v in want.items()}
    for tree in (T.abstract_params(cfg), convert.lm_params_from_seed(cfg, 0)):
        got_paths, leaves, _ = tree_flatten_with_path(tree)
        assert {p: tuple(v.shape) for p, v in zip(got_paths, leaves)} \
            == shapes


def check_forward(model, tokens: np.ndarray, fe: np.ndarray | None = None,
                  tol: float = TOL):
    """Train-mode logits and aux within ``tol`` (default 1e-5; with
    frontend embeddings ``fe``, where given); returns (logits, aux)."""
    jcfg, jparams, cfg, params = model
    jlogits, jaux, _ = _jforward(jparams, jcfg, jnp.asarray(tokens),
                                 frontend_embeds=_j(fe))
    logits, aux, _ = T.forward(params, cfg, torch.from_numpy(tokens).long(),
                               frontend_embeds=_t(fe))
    _close(logits.numpy(), jlogits, tol)
    _close(float(aux), float(jaux), tol)
    return logits, aux


def check_prefill_and_decode(model, tokens: np.ndarray, steps: int,
                             fe: np.ndarray | None = None,
                             tol: float = TOL) -> dict:
    """Prefill (cache of S + ``steps``) and ``steps`` contiguous decode
    steps of seeded tokens (with frontend embeddings ``fe``, where given),
    each side from its own caches: logits and the final caches within
    ``tol`` (default 1e-5).  Returns the port's caches."""
    jcfg, jparams, cfg, params = model
    b, s = tokens.shape[:2]
    jlogits, _, jcaches = _jforward(jparams, jcfg, jnp.asarray(tokens),
                                    frontend_embeds=_j(fe), mode="prefill",
                                    cache_len=s + steps)
    logits, _, caches = T.forward(params, cfg, torch.from_numpy(tokens),
                                  frontend_embeds=_t(fe), mode="prefill",
                                  cache_len=s + steps)
    _close(logits.numpy(), jlogits, tol)
    nxt = prompts(cfg, b, steps, seed=99)
    for i in range(steps):
        pos = np.full((b,), s + i, np.int32)
        jl, jcaches = _jdecode(jparams, jcfg, jnp.asarray(nxt[:, i]),
                               jnp.asarray(pos), jcaches,
                               frontend_embeds=_j(fe))
        lg, caches = T.decode_step(params, cfg, torch.from_numpy(nxt[:, i]),
                                   torch.from_numpy(pos), caches,
                                   frontend_embeds=_t(fe))
        _close(lg.numpy(), jl, tol)
    want = jax.tree.map(np.asarray, jcaches)
    paths, got, _ = tree_flatten_with_path(convert.tree_to_reference(caches))
    wpaths, wleaves, _ = tree_flatten_with_path(want)
    assert paths == wpaths
    for p, a, w in zip(paths, got, wleaves):
        np.testing.assert_allclose(a, w, atol=tol, rtol=0, err_msg=p)
    return caches


def check_generate(model, tokens: np.ndarray, n_new: int,
                   fe: np.ndarray | None = None) -> np.ndarray:
    """Greedy contiguous-cache ``generate`` tokens (with frontend
    embeddings ``fe``, where given) equal the JAX package's; returns
    them."""
    jcfg, jparams, cfg, params = model
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(tokens), n_new,
                                frontend_embeds=_j(fe)))
    got = generate(cfg, params, torch.from_numpy(tokens), n_new,
                   frontend_embeds=_t(fe)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def serve_both(model, prompt_list: list, n_slots: int, n_new: int,
               spec=(4, 33, 8)) -> tuple[dict, dict, object]:
    """Greedy tokens of the JAX engine and of the port's, per prompt, and
    the port's engine."""
    jcfg, jparams, cfg, params = model
    out, engine = [], None
    for eng, sched, req, serve, c, p, kv in (
            (JEngine, JSched, JRequest, jserve, jcfg, jparams, JSpec(*spec)),
            (ServeEngine, ContinuousBatchingScheduler, Request,
             serve_requests, cfg, params, PagedKVSpec(*spec))):
        engine = eng(c, p, kv_spec=kv, n_slots=n_slots, temperature=0.0)
        fin = serve(engine, sched(n_slots, kv),
                    [req(prompt=list(q), max_new_tokens=n_new)
                     for q in prompt_list])
        out.append({tuple(r.prompt): [int(t) for t in r.tokens]
                    for r in fin})
    return out[0], out[1], engine
