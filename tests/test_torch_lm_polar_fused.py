"""The LM trainer under ``GDAHyper(retraction="polar_fused")`` held
against the JAX package's trainer on the CPU, from the same NumPy weights
and batches (a file of its own, beside ``tests/test_torch_lm.py``, so
that the suite's workers run the two in parallel).
"""
from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.gda import GDAHyper as JHyper  # noqa: E402
from repro.core.gda import broadcast_to_nodes as jbroadcast  # noqa: E402
from repro.launch.steps import build_trainer as jbuild  # noqa: E402
from repro.objectives.lm import init_y as jinit_y  # noqa: E402
from repro.sharding.partition import project_params_to_manifold  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (lm_batch_to_torch,  # noqa: E402
                                 lm_params_from_seed,
                                 transformer_params_from_reference,
                                 tree_to_reference)
from repro_torch.core.gda import GDAHyper  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch.steps import (TrainSpec, build_trainer,  # noqa: E402
                                      init_train_state)
from repro_torch.tree import tree_flatten_with_path  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5
BATCH, SEQ, STEPS = 2, 16, 3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _leaves(tree) -> dict:
    paths, leaves, _ = tree_flatten_with_path(tree)
    return dict(zip(paths, leaves))


def test_trainer_under_polar_fused_matches_the_reference():
    """3 DRSGDA steps on 2 nodes under ``GDAHyper(retraction="polar_fused")``
    (every Stiefel leaf retracted by ``ops.fused_retract``; on the card its
    global route takes smollm-135m's 576 x 576 leaves) from
    ``lm_params_from_seed``'s weights, against the JAX trainer with the same
    hyper, weights and batches: every step's loss, grad_norm_x and
    consensus_x, then every parameter and y, within 1e-5, the tolerance of
    ``tests/test_torch_lm.py``'s trainer runs (the recorded run's CPU gap,
    ``LM_CPU_GAP``, is under 5e-7)."""
    jcfg = jconfigs.get_config("smollm-135m", smoke=True)
    cfg = configs.get_config("smollm-135m", smoke=True)
    n_nodes = 2
    hyper = dict(alpha=0.5, beta=0.02, eta=0.05, retraction="polar_fused")
    params = lm_params_from_seed(cfg, 0)
    stream = TokenStream(n_nodes, BATCH, SEQ, cfg.vocab_size,
                         n_groups=cfg.n_groups, seed=1)
    batches = [stream.batch(t) for t in range(STEPS + 1)]

    def jb(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    jopt, _ = jbuild(jcfg, n_nodes, optimizer="drsgda", hyper=JHyper(**hyper))
    x0 = jbroadcast(project_params_to_manifold(
        jax.tree.map(jnp.asarray, params), jopt.problem.manifold_map),
        n_nodes)
    jstate = jopt.init(x0, jinit_y(jcfg, n_nodes), jb(batches[0]))
    jstep = jopt.make_step(donate=False)
    opt, _ = build_trainer(cfg, n_nodes,
                           TrainSpec(hyper=GDAHyper(**hyper)))
    state = init_train_state(None, cfg, opt, n_nodes,
                             lm_batch_to_torch(batches[0], "cpu"),
                             params=transformer_params_from_reference(
                                 params, "cpu"))
    for t in range(1, STEPS + 1):
        jstate, jm = jstep(jstate, jb(batches[t]))
        state, m = opt.step(state, lm_batch_to_torch(batches[t], "cpu"))
        for key in ("loss", "grad_norm_x", "consensus_x"):
            _close(getattr(m, key), getattr(jm, key))
    want = _leaves(jax.tree.map(np.asarray, jstate.x))
    for p, x in _leaves(tree_to_reference(state.x)).items():
        _close(x, want[p])
    _close(state.y, jstate.y)
