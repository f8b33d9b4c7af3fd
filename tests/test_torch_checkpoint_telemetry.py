"""A trainer state with telemetry crosses the two packages' checkpoints.

The LM trainer (DRSGDA, smollm-135m ``SMOKE``, 2 nodes) with telemetry
on, in both packages from the JAX initial weights: one package's state
after one step is saved, the other package restores it into a fresh state
of its own trainer and takes the second step.  The wire counters then
equal the writer's own run after two steps bit for bit (the port saves
its two counter halves as the JAX package's one packed ``f32[6]`` leaf
and splits it on restore), and x and y agree with it within 1e-5 (the
trainer's tolerance in ``tests/test_torch_lm.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import build_trainer as jbuild  # noqa: E402
from repro.launch.steps import init_train_state as jinit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs import Telemetry as JTelemetry  # noqa: E402
from repro_torch import checkpoint, configs  # noqa: E402
from repro_torch.convert import (lm_batch_to_torch,  # noqa: E402
                                 transformer_params_from_reference,
                                 tree_to_reference)
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch.steps import (TrainSpec, build_trainer,  # noqa: E402
                                      init_train_state)
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.obs.wire import pack  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

TOL = 1e-5
N_NODES, BATCH, SEQ = 2, 2, 16


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _leaves(tree) -> dict:
    paths, leaves, _ = tree_flatten_with_path(tree)
    return dict(zip(paths, leaves))


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Both trainers with telemetry on, their fresh states, and the states
    after one and two steps."""
    tmp = tmp_path_factory.mktemp("tel")
    jcfg = jconfigs.get_config("smollm-135m", smoke=True)
    cfg = configs.get_config("smollm-135m", smoke=True)
    stream = TokenStream(N_NODES, BATCH, SEQ, cfg.vocab_size,
                         n_groups=cfg.n_groups, seed=0)
    batches = [stream.batch(t) for t in range(3)]

    jopt, _ = jbuild(jcfg, N_NODES, telemetry=JTelemetry(
        run="j", out_dir=str(tmp / "j"), flush_every=10**6))
    jstep = jopt.make_step(donate=False)

    def jfresh():
        return jinit(jax.random.PRNGKey(0), jcfg, jopt, N_NODES,
                     _jb(batches[0]))

    raw = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    opt, _ = build_trainer(cfg, N_NODES, TrainSpec(telemetry=Telemetry(
        run="t", out_dir=str(tmp / "t"), flush_every=10**6)))

    def fresh():
        return init_train_state(None, cfg, opt, N_NODES,
                                lm_batch_to_torch(batches[0], "cpu"),
                                params=transformer_params_from_reference(
                                    raw, "cpu"))

    jstates, states = [jfresh()], [fresh()]
    for t in (1, 2):
        jstates.append(jstep(jstates[-1], _jb(batches[t]))[0])
        states.append(opt.step(states[-1],
                               lm_batch_to_torch(batches[t], "cpu"))[0])
    return dict(jstep=jstep, jfresh=jfresh, opt=opt, fresh=fresh,
                batch=batches[2], jstates=jstates, states=states)


def _check(counters, x, y, want_counters, want_x, want_y):
    np.testing.assert_array_equal(counters, want_counters)
    assert counters[0] > 0 and counters[2] > 0
    for p, v in _leaves(x).items():
        np.testing.assert_allclose(v, want_x[p], rtol=TOL, atol=TOL,
                                   err_msg=p)
    np.testing.assert_allclose(y, want_y, rtol=TOL, atol=TOL)


def test_jax_checkpoint_resumes_in_the_port(trainers, tmp_path):
    """The JAX state after one step, saved by the JAX package, restored by
    the port and stepped once: the JAX run's counters after two steps."""
    d = str(tmp_path / "ckpt")
    jckpt.save(d, 1, trainers["jstates"][1])
    like = trainers["fresh"]()
    assert tree_flatten_with_path(
        like, lambda n: n is like.obs)[0] == jckpt._paths(
            trainers["jstates"][1])
    resumed = checkpoint.restore(d, 1, like, device="cpu")
    assert resumed.step == 1
    np.testing.assert_array_equal(pack(resumed.obs),
                                  np.asarray(trainers["jstates"][1].obs))
    state, _ = trainers["opt"].step(
        resumed, lm_batch_to_torch(trainers["batch"], "cpu"))
    want = trainers["jstates"][2]
    _check(pack(state.obs), tree_to_reference(state.x), state.y.numpy(),
           np.asarray(want.obs), _leaves(jax.tree.map(np.asarray, want.x)),
           np.asarray(want.y))


def test_port_checkpoint_resumes_in_the_jax_trainer(trainers, tmp_path):
    """The port's state after one step, saved by the port, restored by the
    JAX package and stepped once: the port's counters after two steps."""
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, trainers["states"][1])
    resumed = jckpt.restore(d, 1, trainers["jfresh"]())
    assert int(resumed.step) == 1
    np.testing.assert_array_equal(np.asarray(resumed.obs),
                                  pack(trainers["states"][1].obs))
    jstate, _ = trainers["jstep"](resumed, _jb(trainers["batch"]))
    want = trainers["states"][2]
    _check(np.asarray(jstate.obs),
           _leaves(jax.tree.map(np.asarray, jstate.x)), np.asarray(jstate.y),
           pack(want.obs), _leaves(tree_to_reference(want.x)),
           want.y.numpy())
