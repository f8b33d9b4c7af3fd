"""The port's baselines (``repro_torch.core.baselines``) against the JAX
package's ``repro.core.baselines``, with the same weights
(``repro_torch.convert``) and the same NumPy batches, on the fair CNN at
n = 4 and 8x8 images.

Tolerances, as for DRGDA in ``tests/test_torch_fair.py``: the 10-step
trajectories of GT-GDA, GNSD-A, DM-HSGD and GT-SRVR (q = 4, so anchors at
t = 0, 4 and 8) to 1e-5 per step in loss, every x leaf and y, and 1e-5
relative in the final M_t: both packages round the same fp32 operations in
other orders.  The projection back and the Euclidean gradients to 1e-6 on
one state.  GT-SRVR under EF-int8 gossip with the JAX package's draws, 5
steps: each step from the reference's own state within the larger of 1e-5
and one quantization step of x's slot per node row, the free-running
trajectory within 1e-3 in loss and 2e-3 relative in the final M_t (the
gates of ``test_ef_int8_trajectory_matches_reference``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _jax_draws import JaxDraws  # noqa: E402
from repro.comms.spec import CommSpec as JCommSpec  # noqa: E402
from repro.core import OPTIMIZERS as J_OPTIMIZERS  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core import gda as jgda  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.core.metric import convergence_metric as j_metric  # noqa: E402
from repro.data.synthetic import ClassificationStream as JStream  # noqa: E402
from repro.objectives import fair as jfair  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import OPTIMIZERS  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core.gda import GDAHyper  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.core.metric import convergence_metric  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.fair import COMM_PRESETS, prepare  # noqa: E402
from repro_torch.objectives import fair  # noqa: E402

N, HW, FC = 4, 8, 16
Q = 4          # GT-SRVR's anchor period here: anchors at t = 0, 4 and 8
HYPERS = {     # benchmarks/fair_classification.py:52-58, q = Q
    "gt-gda": (jgda.GDAHyper, GDAHyper, dict(alpha=0.5, beta=0.05, eta=0.2)),
    "gnsd-a": (jgda.GDAHyper, GDAHyper, dict(alpha=0.5, beta=0.05, eta=0.2)),
    "dm-hsgd": (jb.HSGDHyper, tb.HSGDHyper, dict(beta=0.05, eta=0.2, bx=0.1)),
    "gt-srvr": (jb.SRVRHyper, tb.SRVRHyper, dict(beta=0.05, eta=0.2, q=Q)),
}


def _np(t):
    return t.detach().cpu().numpy()


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def setup():
    params = jfair.init_cnn(jax.random.PRNGKey(0), image_hw=HW, fc=FC)
    stream = JStream(n_nodes=N, batch_per_node=8, image_hw=HW, seed=0)
    return params, stream


def _pair(name, params, comm=None, draws=None):
    """The JAX package's optimizer ``name`` and the port's, on the same
    problem, gossip and hyper-parameters."""
    jhyper, thyper, kw = HYPERS[name]
    jspec = JSpec(n_nodes=N, k_steps=1, comm=None if comm is None else
                  JCommSpec(**dataclasses.asdict(comm)))
    jopt = J_OPTIMIZERS[name](jfair.make_fair_problem(params), jspec,
                              jhyper(**kw))
    topt = OPTIMIZERS[name](fair.make_fair_problem({}),
                            GossipSpec(n_nodes=N, k_steps=1, comm=comm),
                            thyper(**kw), draws=draws)
    return jopt, topt


def _jax_steps(jopt, name):
    """(step, anchor_step) jitted; anchor_step None but for GT-SRVR."""
    anchor = jax.jit(jopt.anchor_step) if name == "gt-srvr" else None
    return jax.jit(jopt.step), anchor


def _batch(stream, full, det, t):
    return full if det else stream.batch(t + 1)


def _j_mt(jopt, js, full):
    return float(jax.jit(functools.partial(j_metric, jopt.problem))(
        js.x, js.y, _jbatch(full))["M_t"])


def _t_mt(topt, ts, full):
    return float(convergence_metric(topt.problem, ts.x, ts.y,
                                    convert.batch_to_torch(full, "cpu"))
                 ["M_t"])


@pytest.mark.parametrize("name", ["gt-gda", "gnsd-a", "dm-hsgd", "gt-srvr"])
def test_baseline_trajectory_matches_reference(setup, name):
    params, stream = setup
    det = name == "gt-gda"
    jopt, topt = _pair(name, params)
    x0 = jgda.broadcast_to_nodes(params, N)
    full = stream.full(2)
    b0 = full if det else stream.batch(0)
    js = jopt.init(x0, jnp.full((N, 3), 1.0 / 3.0), _jbatch(b0))
    ts = topt.init(convert.params_from_reference(x0, "cpu"),
                   torch.full((N, 3), 1.0 / 3.0),
                   convert.batch_to_torch(b0, "cpu"))
    step, anchor = _jax_steps(jopt, name)
    for t in range(10):
        if anchor is not None and t % Q == 0:
            js, jm = anchor(js, _jbatch(full))
            ts, tm = topt.anchor_step(ts, convert.batch_to_torch(full, "cpu"))
        else:
            b = _batch(stream, full, det, t)
            js, jm = step(js, _jbatch(b))
            ts, tm = topt.step(ts, convert.batch_to_torch(b, "cpu"))
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        tx = convert.params_to_reference(ts.x)
        for key in tx:
            np.testing.assert_allclose(tx[key], np.asarray(js.x[key]),
                                       atol=1e-5)
        np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), atol=1e-5)
    want, got = _j_mt(jopt, js, full), _t_mt(topt, ts, full)
    assert abs(got - want) <= 1e-5 * want


def test_project_back_and_euclid_grads_match_reference(setup):
    params, stream = setup
    rng = np.random.default_rng(3)
    x = {k: np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32)
         for k, v in jgda.broadcast_to_nodes(params, N).items()}
    y = rng.dirichlet(np.ones(3), size=N).astype(np.float32)
    b = stream.batch(1)
    jprob, tprob = jfair.make_fair_problem(params), fair.make_fair_problem({})
    tx = convert.params_from_reference(x, "cpu")
    jx = {k: jnp.asarray(v) for k, v in x.items()}

    want = jb._project_back(jprob.manifold_map, jx)
    got = convert.params_to_reference(tb._project_back(tprob.manifold_map,
                                                       tx))
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-6)

    jloss, (jgx, jgy) = jax.jit(functools.partial(jb._euclid_grads, jprob))(
        jx, jnp.asarray(y), _jbatch(b))
    tloss, tgx, tgy = tb._euclid_grads(tprob, tx, torch.from_numpy(y),
                                       convert.batch_to_torch(b, "cpu"))
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=1e-6)
    tgx = convert.params_to_reference(tgx)
    for key in jgx:
        np.testing.assert_allclose(tgx[key], np.asarray(jgx[key]), atol=1e-6)
    np.testing.assert_allclose(_np(tgy), np.asarray(jgy), atol=1e-6)


def _port_slot(tree):
    if isinstance(tree, dict):
        return convert.params_from_reference(jax.tree.map(np.asarray, tree),
                                             "cpu")
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _port_srvr_state(js):
    """The JAX package's SRVRState (with its comms memory) as the port's."""
    fields = {f.name: _port_slot(getattr(js, f.name))
              for f in dataclasses.fields(tb.SRVRState)
              if f.name not in ("step", "comm")}
    hats = {slot: jax.tree.map(np.asarray, t)
            for slot, t in js.comm.hats.items()}
    return tb.SRVRState(**fields, step=int(js.step),
                        comm=convert.comm_state_from_reference(hats, None,
                                                               "cpu"))


def test_gt_srvr_ef_int8_trajectory_matches_reference(setup):
    params, stream = setup
    comm = COMM_PRESETS["int8_ef"]
    jopt, topt = _pair("gt-srvr", params, comm, JaxDraws(comm))
    full = stream.full(2)
    tfull = convert.batch_to_torch(full, "cpu")
    js = jopt.init(jgda.broadcast_to_nodes(params, N),
                   jnp.full((N, 3), 1.0 / 3.0), _jbatch(stream.batch(0)))
    free = topt.init(_port_slot(js.x), torch.full((N, 3), 1.0 / 3.0),
                     convert.batch_to_torch(stream.batch(0), "cpu"))
    step, anchor = _jax_steps(jopt, "gt-srvr")
    for t in range(5):
        qstep = {key: np.abs((np.asarray(js.x[key])
                              - np.asarray(js.comm.hats["x"][key])
                              ).reshape(N, -1)).max(1) / 127.0
                 for key in js.x}
        is_anchor = t % Q == 0
        b = full if is_anchor else stream.batch(t + 1)
        tb_ = convert.batch_to_torch(b, "cpu")
        jn, jm = (anchor if is_anchor else step)(js, _jbatch(b))
        # one port step from the reference's own state
        forced = topt.anchor_step if is_anchor else topt.step
        tn, tm = forced(_port_srvr_state(js), tb_)
        tx = convert.params_to_reference(tn.x)
        for key in tx:
            diff = np.abs(tx[key] - np.asarray(jn.x[key])).reshape(N, -1)
            gate = np.maximum(1e-5, qstep[key])
            assert (diff.max(1) <= gate).all(), (t, key, diff.max(1), gate)
        np.testing.assert_allclose(_np(tn.y), np.asarray(jn.y), atol=1e-5)
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        # the free-running port trajectory
        free, fm = (topt.anchor_step if is_anchor else topt.step)(free, tb_)
        assert abs(float(fm.loss) - float(jm.loss)) <= 1e-3, t
        js = jn
    want = _j_mt(jopt, js, full)
    got = float(convergence_metric(topt.problem, free.x, free.y, tfull)
                ["M_t"])
    assert abs(got - want) <= 2e-3 * want


@pytest.mark.parametrize("name,det,comm,per_step", [
    # every mix one hop: one grouped ring call per mixed tree (x, y, u, v),
    # no projection, retraction or multi-hop call
    ("gt-gda", True, None, {"ring": 4, "multi": 0, "quant": 0, "project": 0,
                            "retract": 0}),
    ("gnsd-a", False, None, {"ring": 4, "multi": 0, "quant": 0, "project": 0,
                             "retract": 0}),
    ("dm-hsgd", False, None, {"ring": 4, "multi": 0, "quant": 0,
                              "project": 0, "retract": 0}),
    ("gt-srvr", False, None, {"ring": 4, "multi": 0, "quant": 0,
                              "project": 0, "retract": 0}),
    # EF-int8: one grouped first hop per tree, no exact ring mix
    ("gt-srvr", False, COMM_PRESETS["int8_ef"], {"ring": 0, "multi": 0,
                                                 "quant": 4, "project": 0,
                                                 "retract": 0}),
    # DRGDA under Cayley: one grouped projection of the gradient (fc1 and
    # head) and, per Stiefel leaf, the two projections of descent_update
    ("drgda", True, None, {"ring": 4, "multi": 0, "quant": 0, "project": 5,
                           "retract": 0}),
])
def test_step_calls_per_step(monkeypatch, name, det, comm, per_step):
    """The kernel wrappers a step calls (each call one launch on the card
    at the fair shapes): ``chip_smoke.py`` holds the card's launch counts
    to these.  GT-SRVR's anchor step calls the same."""
    calls = dict.fromkeys(per_step, 0)

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    for key, attr in (("ring", "ring_mix_leaves"),
                      ("multi", "multi_hop_mix_leaves"),
                      ("quant", "quant_mix_leaves"),
                      ("project", "stiefel_project_leaves"),
                      ("retract", "fused_retract")):
        monkeypatch.setattr(ops, attr, spy(key, getattr(ops, attr)))
    run = prepare(name, det, image_hw=8, n_nodes=5, device="cpu", comm=comm,
                  retraction="cayley")
    calls.update(dict.fromkeys(calls, 0))
    state = run.state
    steps = 2
    for t in range(steps):
        if name == "gt-srvr" and t == 0:
            state, _ = run.opt.anchor_step(state, run.full)
        else:
            state, _ = run.opt.step(state, run.full)
    assert calls == {key: c * steps for key, c in per_step.items()}
