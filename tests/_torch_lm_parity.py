"""Shared check of the port's LM trainer against the JAX trainer on the
CPU, for the architectures of ``tests/test_torch_lm_moe.py`` and
``tests/test_torch_lm_streams.py``: ``SMOKE`` configs, the JAX package's
initial weights (``PRNGKey(0)``) carried over with
``repro_torch.convert``, the same ``TokenStream`` batches (codebooks
included) and, for a model with a frontend, the same NumPy embeddings in
both batches.  Imported after ``pytest.importorskip("jax")``.

Tolerance: 1e-5, absolute and relative, as ``tests/test_torch_lm.py``'s
trainer runs (the recorded smollm run's CPU gap is under 5e-7).
"""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.core.gda import GDAHyper as JHyper
from repro.core.metric import convergence_metric as jmetric
from repro.launch.steps import build_trainer as jbuild
from repro.launch.steps import init_train_state as jinit
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import (lm_batch_to_torch, lm_frontend_from_seed,
                                 transformer_params_from_reference,
                                 tree_to_reference)
from repro_torch.core.gda import GDAHyper
from repro_torch.core.metric import convergence_metric
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.steps import TrainSpec, build_trainer, init_train_state
from repro_torch.tree import tree_flatten_with_path

TOL = 1e-5
N_NODES, BATCH, SEQ, STEPS = 4, 2, 16, 3
# XLA:CPU options for the JAX programs compiled here: LLVM's expensive
# passes off halves the compile, most of each case's time; the programs
# compute the same fp32 operations (no fast math)
COMPILE = {"xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    """``fn`` (jitted) compiled for ``args`` with :data:`COMPILE`."""
    return fn.lower(*args).compile(compiler_options=COMPILE)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _leaves(tree) -> dict:
    paths, leaves, _ = tree_flatten_with_path(tree)
    return dict(zip(paths, leaves))


def check_trainer(arch: str, retraction: str = "polar") -> dict:
    """3 DRSGDA steps on a 4-node ring, fresh minibatches, with
    ``build_trainer``'s default hyper (``retraction`` replaced): every
    step's loss, grad_norm_x and consensus_x, then every parameter, y and
    M_t within 1e-5 of the JAX trainer.  Returns the port's last
    metrics.  The port runs on one CPU thread (its tensors are small;
    beside the suite's other workers, more threads only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _check_trainer(arch, retraction)
    finally:
        torch.set_num_threads(threads)


def _check_trainer(arch: str, retraction: str):
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    # jitted: op by op, the JAX package compiles every op of a step anew
    key = jax.random.PRNGKey(0)
    raw = jax.tree.map(np.asarray, _compiled(
        jax.jit(lambda k: JT.init_params(k, jcfg)), key)(key))
    stream = TokenStream(N_NODES, BATCH, SEQ, cfg.vocab_size,
                         n_groups=cfg.n_groups, n_codebooks=cfg.n_codebooks,
                         seed=0)
    fe = None if cfg.frontend is None else lm_frontend_from_seed(
        cfg, N_NODES, BATCH, seed=1)
    batches = []
    for t in range(STEPS + 1):
        b = dict(stream.batch(t))
        if fe is not None:
            b["frontend_embeds"] = fe
        batches.append(b)

    def jb(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    hyper = dict(alpha=0.5, beta=0.02, eta=0.05, retraction=retraction)
    jopt, jproblem = jbuild(jcfg, N_NODES, hyper=JHyper(**hyper))
    # the JAX init draws the same weights (PRNGKey(0)); the port takes them
    b0 = jb(batches[0])
    jstate = _compiled(jax.jit(lambda b: jinit(key, jcfg, jopt, N_NODES, b)),
                       b0)(b0)
    jstep = _compiled(jopt.make_step(donate=False), jstate, jb(batches[1]))
    opt, problem = build_trainer(cfg, N_NODES,
                                 TrainSpec(hyper=GDAHyper(**hyper)))
    state = init_train_state(None, cfg, opt, N_NODES,
                             lm_batch_to_torch(batches[0], "cpu"),
                             params=transformer_params_from_reference(
                                 raw, "cpu"))
    for t in range(1, STEPS + 1):
        jstate, jm = jstep(jstate, jb(batches[t]))
        state, m = opt.step(state, lm_batch_to_torch(batches[t], "cpu"))
        for key in ("loss", "grad_norm_x", "consensus_x"):
            _close(getattr(m, key), getattr(jm, key), what=f"{key} step {t}")
    want = _leaves(jax.tree.map(np.asarray, jstate.x))
    got = _leaves(tree_to_reference(state.x))
    assert got.keys() == want.keys()
    for p, x in got.items():
        _close(x, want[p], what=p)
    _close(state.y, jstate.y, what="y")
    last = lm_batch_to_torch(batches[-1], "cpu")
    mt = convergence_metric(problem, state.x, state.y, last)
    args = (jstate.x, jstate.y, jb(batches[-1]))
    ref = _compiled(jax.jit(lambda x, y, b: jmetric(jproblem, x, y, b)),
                    *args)(*args)
    for key in ("M_t", "consensus_x", "dist_y_star"):
        _close(mt[key], ref[key], what=key)
    return m
