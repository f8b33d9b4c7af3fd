"""The port's fair-classification objective, optimizer and entry point
against the JAX package, with the same weights (``repro_torch.convert``)
and the same NumPy batches.

Tolerances: the objective, its gradients and y* to 1e-5 (fp32 convolutions
and products summed in another order); the DRGDA/DRSGDA trajectories over
10 steps to 1e-5 per step in loss and in every parameter, and 1e-5 relative
in the final M_t.  Measured differences are a few 1e-7: the two packages
round the same fp32 operations in different orders, and 10 steps of the
method do not amplify that past 1e-6.

EF-int8 gossip (the JAX package's draws handed in): stochastic rounding
``floor(x/scale + u)`` turns a difference of a few 1e-7 in ``x`` into a
whole int8 step where ``x/scale + u`` lies that close to an integer (a
flip), and error feedback carries it on.  So each of 10 steps is held on
the reference's trajectory (both packages step from the same state, carried
over with ``convert``) at the larger of 1e-5 and one quantization step of
the slot, ``max|x - x_hat| / 127`` per node row (the JAX package's own gate
for its int8 kernel); the free-running 10-step trajectories, which flips
separate, are held to 1e-3 in loss and 2e-3 relative in the final M_t
(measured: 1e-4 and 4e-4).
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
from repro.core import gda as jgda  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.core.metric import convergence_metric as j_metric  # noqa: E402
from repro.data.synthetic import ClassificationStream as JStream  # noqa: E402
from repro.objectives import fair as jfair  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comms.spec import CommSpec  # noqa: E402
from repro_torch.core import OPTIMIZERS  # noqa: E402
from repro_torch.core import gda as tgda  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.core.metric import convergence_metric  # noqa: E402
from repro_torch.data.synthetic import ClassificationStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.fair import COMM_PRESETS, run_method  # noqa: E402
from repro_torch.objectives import fair  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

N, HW, FC = 4, 8, 16


def _np(t):
    return t.detach().cpu().numpy()


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(autouse=True)
def _no_tuned_configs(monkeypatch):
    # the JAX package's tune cache may set other ns_iters for
    # fused_retract; hold both packages to the default 20 iterations
    monkeypatch.setenv("REPRO_TUNE", "off")


@pytest.fixture(scope="module")
def setup():
    params = jfair.init_cnn(jax.random.PRNGKey(0), image_hw=HW, fc=FC)
    stream = JStream(n_nodes=N, batch_per_node=8, image_hw=HW, seed=0)
    return params, stream


def test_stream_is_the_reference_stream():
    a = ClassificationStream(n_nodes=5, batch_per_node=6, image_hw=7, seed=3)
    b = JStream(n_nodes=5, batch_per_node=6, image_hw=7, seed=3)
    for got, want in [(a.batch(2), b.batch(2)), (a.full(3), b.full(3))]:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_convert_round_trip(setup):
    params, _ = setup
    stacked = jgda.broadcast_to_nodes(params, 3)
    for tree in (params, stacked):
        back = convert.params_to_reference(
            convert.params_from_reference(tree, "cpu"))
        for k in tree:
            np.testing.assert_array_equal(back[k], np.asarray(tree[k]))
    port = convert.params_from_reference(params, "cpu")
    assert port["conv2"].shape == (16, 8, 3, 3)       # OIHW


def test_objective_grads_and_y_star(setup):
    params, stream = setup
    b = stream.batch(1)
    node = {k: v[0] for k, v in b.items()}
    u = np.array([0.2, 0.5, 0.3], np.float32)
    tp = convert.params_from_reference(params, "cpu")
    tb = convert.batch_to_torch(node, "cpu")
    jp = fair.make_fair_problem(tp)
    jref = jfair.make_fair_problem(params)

    np.testing.assert_allclose(
        _np(fair.cnn_forward(tp, tb["images"])),
        np.asarray(jax.jit(jfair.cnn_forward)(params,
                                              jnp.asarray(node["images"]))),
        atol=1e-5)
    np.testing.assert_allclose(
        float(jp.value(tp, torch.from_numpy(u), tb)),
        float(jax.jit(jref.value)(params, jnp.asarray(u), _jbatch(node))),
        atol=1e-5)
    tgx, tgy = jp.rgrads(tp, torch.from_numpy(u), tb)
    jgx, jgy = jax.jit(jref.rgrads)(params, jnp.asarray(u), _jbatch(node))
    tgx = convert.params_to_reference(tgx)
    for k in jgx:
        np.testing.assert_allclose(tgx[k], np.asarray(jgx[k]), atol=1e-5)
    np.testing.assert_allclose(_np(tgy), np.asarray(jgy), atol=1e-5)
    np.testing.assert_allclose(
        _np(jp.y_star(tp, convert.batch_to_torch(b, "cpu"))),
        np.asarray(jax.jit(jref.y_star)(params, _jbatch(b))), atol=1e-5)

    dp, dref = fair.make_dro_problem(tp), jfair.make_dro_problem(params)
    np.testing.assert_allclose(
        float(dp.value(tp, torch.from_numpy(u), tb)),
        float(jax.jit(dref.value)(params, jnp.asarray(u), _jbatch(node))),
        atol=1e-5)
    np.testing.assert_allclose(
        _np(dp.y_star(tp, convert.batch_to_torch(b, "cpu"))),
        np.asarray(jax.jit(dref.y_star)(params, _jbatch(b))), atol=1e-5)


def test_convergence_metric(setup):
    params, stream = setup
    rng = np.random.default_rng(0)
    x = {k: np.asarray(v) + 0.01 * rng.normal(size=v.shape).astype(np.float32)
         for k, v in jgda.broadcast_to_nodes(params, N).items()}
    from repro.geometry import get as jget
    for k in ("fc1", "head"):   # back onto the manifold, node by node
        x[k] = np.asarray(jget("stiefel").feasible_init(jnp.asarray(x[k])))
    y = rng.dirichlet(np.ones(3), size=N).astype(np.float32)
    full = stream.full(2)
    want = jax.jit(functools.partial(j_metric, jfair.make_fair_problem(params)))(
        {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(y),
        _jbatch(full))
    tx = convert.params_from_reference(x, "cpu")
    got = convergence_metric(fair.make_fair_problem(tx), tx,
                             torch.from_numpy(y),
                             convert.batch_to_torch(full, "cpu"))
    for key in ("M_t", "grad_norm", "consensus_x", "dist_y_star"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-6)
    assert float(got["stiefel_residual"]) < 1e-5


@pytest.mark.parametrize("method", ["drgda", "drsgda"])
@pytest.mark.parametrize("retraction", ["polar", "polar_fused"])
def test_trajectory_matches_reference(setup, method, retraction):
    params, stream = setup
    det = method == "drgda"
    k = 1 if det else 3
    hyper = dict(alpha=0.5, beta=0.05, eta=0.2, retraction=retraction)
    jprob, tprob = jfair.make_fair_problem(params), fair.make_fair_problem({})
    jopt = J_OPTIMIZERS[method](jprob, JSpec(n_nodes=N, k_steps=k),
                                jgda.GDAHyper(**hyper))
    topt = OPTIMIZERS[method](tprob, GossipSpec(n_nodes=N, k_steps=k),
                                   tgda.GDAHyper(**hyper))
    x0 = jgda.broadcast_to_nodes(params, N)
    full = stream.full(2)
    b0 = full if det else stream.batch(0)
    js = jopt.init(x0, jnp.full((N, 3), 1.0 / 3.0), _jbatch(b0))
    ts = topt.init(convert.params_from_reference(x0, "cpu"),
                   torch.full((N, 3), 1.0 / 3.0),
                   convert.batch_to_torch(b0, "cpu"))
    step = jax.jit(jopt.step)
    for t in range(10):
        b = full if det else stream.batch(t + 1)
        js, jm = step(js, _jbatch(b))
        ts, tm = topt.step(ts, convert.batch_to_torch(b, "cpu"))
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        tx = convert.params_to_reference(ts.x)
        for key in tx:
            np.testing.assert_allclose(tx[key], np.asarray(js.x[key]),
                                       atol=1e-5)
        np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), atol=1e-5)
    want = float(jax.jit(functools.partial(j_metric, jprob))(
        js.x, js.y, _jbatch(full))["M_t"])
    got = float(convergence_metric(tprob, ts.x, ts.y,
                                   convert.batch_to_torch(full, "cpu"))["M_t"])
    assert abs(got - want) <= 1e-5 * want


def _port_slot(tree):
    if isinstance(tree, dict):
        return convert.params_from_reference(jax.tree.map(np.asarray, tree),
                                             "cpu")
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _port_state(js):
    """The JAX package's GDAState (with its comms memory) as the port's."""
    hats = {slot: jax.tree.map(np.asarray, t)
            for slot, t in js.comm.hats.items()}
    return tgda.GDAState(
        x=_port_slot(js.x), y=_port_slot(js.y), u=_port_slot(js.u),
        v=_port_slot(js.v), gx_prev=_port_slot(js.gx_prev),
        gy_prev=_port_slot(js.gy_prev), step=int(js.step),
        comm=convert.comm_state_from_reference(hats, None, "cpu"))


def _payload_flips(t_hats, t_old, j_hats, j_old, qstep):
    """Payload elements (hat increments) that differ by half a step or
    more: stochastic-rounding flips and what error feedback carried on."""
    flips = 0
    for key, step in qstep.items():
        d = (t_hats[key] - t_old[key]) - (np.asarray(j_hats[key])
                                          - np.asarray(j_old[key]))
        flips += int((np.abs(d).reshape(N, -1) > 0.5 * step[:, None]).sum())
    return flips


@pytest.mark.parametrize("k,quant_hops", [(1, "first"), (3, "all")])
def test_ef_int8_trajectory_matches_reference(setup, k, quant_hops):
    params, stream = setup
    comm = CommSpec(compressor="int8", gamma=0.95, quant_hops=quant_hops)
    hyper = dict(alpha=0.5, beta=0.05, eta=0.2, retraction="polar_fused")
    jprob, tprob = jfair.make_fair_problem(params), fair.make_fair_problem({})
    jspec = JSpec(n_nodes=N, k_steps=k,
                  comm=JCommSpec(**dataclasses.asdict(comm)))
    jopt = J_OPTIMIZERS["drgda"](jprob, jspec, jgda.GDAHyper(**hyper))
    topt = tgda.DRGDA(tprob, GossipSpec(n_nodes=N, k_steps=k, comm=comm),
                      tgda.GDAHyper(**hyper), draws=JaxDraws(comm))
    full = stream.full(2)
    tb = convert.batch_to_torch(full, "cpu")
    js = jopt.init(jgda.broadcast_to_nodes(params, N),
                   jnp.full((N, 3), 1.0 / 3.0), _jbatch(full))
    free = topt.init(_port_slot(js.x), torch.full((N, 3), 1.0 / 3.0), tb)
    step = jax.jit(jopt.step)
    forced_flips, free_flips = 0, []
    for t in range(10):
        qstep = {key: np.abs((np.asarray(js.x[key])
                              - np.asarray(js.comm.hats["x"][key])
                              ).reshape(N, -1)).max(1) / 127.0
                 for key in js.x}
        jn, jm = step(js, _jbatch(full))
        # one port step from the reference's own state
        tn, tm = topt.step(_port_state(js), tb)
        tx = convert.params_to_reference(tn.x)
        for key in tx:
            diff = np.abs(tx[key] - np.asarray(jn.x[key])).reshape(N, -1)
            gate = np.maximum(1e-5, qstep[key])
            assert (diff.max(1) <= gate).all(), (t, key, diff.max(1), gate)
        np.testing.assert_allclose(_np(tn.y), np.asarray(jn.y), atol=1e-5)
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        forced_flips += _payload_flips(
            convert.params_to_reference(tn.comm.hats["x"]),
            convert.params_to_reference(_port_state(js).comm.hats["x"]),
            jn.comm.hats["x"], js.comm.hats["x"], qstep)
        # the free-running port trajectory
        old = convert.params_to_reference(free.comm.hats["x"])
        free, fm = topt.step(free, tb)
        free_flips.append(_payload_flips(
            convert.params_to_reference(free.comm.hats["x"]), old,
            jn.comm.hats["x"], js.comm.hats["x"], qstep))
        assert abs(float(fm.loss) - float(jm.loss)) <= 1e-3, t
        js = jn
    assert forced_flips == 0
    want = float(jax.jit(functools.partial(j_metric, jprob))(
        js.x, js.y, _jbatch(full))["M_t"])
    got = float(convergence_metric(tprob, free.x, free.y, tb)["M_t"])
    print(f"EF-int8 k={k} quant_hops={quant_hops}: payload flips of x per "
          f"free-running step {free_flips}; final M_t {got:.6f} (port) vs "
          f"{want:.6f} (reference)")
    assert abs(got - want) <= 2e-3 * want


def test_run_method_on_the_cpu():
    res = run_method("drsgda", 5, False, image_hw=8, n_nodes=4, k_steps=None,
                     eval_every=2, device="cpu")
    assert res["k"] == GossipSpec(n_nodes=4).k
    # step 1, every eval_every-th step, and always the last step
    assert [p["step"] for p in res["curve"]] == [1, 2, 4, 5]
    for p in res["curve"]:
        assert np.isfinite([p["loss"], p["M_t"]]).all()
        assert p["stiefel_residual"] < 1e-4
    # the baselines and the Cayley retraction run; an unknown name raises
    for name, retraction in (("gt-gda", "polar"), ("drgda", "cayley")):
        res = run_method(name, 1, True, image_hw=8, n_nodes=3,
                         retraction=retraction, device="cpu")
        assert np.isfinite(res["final_M_t"]) and res["k"] == 1
    with pytest.raises(ValueError, match="unknown method"):
        run_method("gt-gdaa", 1, True, device="cpu")
    with pytest.raises(ValueError, match="unknown retraction"):
        run_method("drgda", 1, True, retraction="cayly", device="cpu")


_INT8_ALL = dataclasses.replace(COMM_PRESETS["int8_ef"], quant_hops="all")


# k = 3 takes the branch of every k > 1 (the Theorem-1 k = 67 of the card's
# run) at a fraction of the CPU time
@pytest.mark.parametrize("name,det,k,comm,per_step", [
    # one grouped call per mixed tree: x, y, u with k hops, v with one
    ("drgda", True, 1, None, {"ring": 4, "multi": 0, "quant": 0}),
    ("drsgda", False, 1, None, {"ring": 4, "multi": 0, "quant": 0}),
    ("drgda", True, 3, None, {"ring": 1, "multi": 3, "quant": 0}),
    # EF-int8: one grouped int8 first hop per tree, the error-feedback hop
    # of the four hats fused into it
    ("drgda", True, 1, COMM_PRESETS["int8_ef"], {"ring": 0, "multi": 0,
                                                 "quant": 4}),
    ("drgda", True, 3, _INT8_ALL, {"ring": 0, "multi": 0, "quant": 4}),
    ("drgda", True, 1, COMM_PRESETS["int8_ef_drop5"], {"ring": 0,
                                                       "multi": 0,
                                                       "quant": 0}),
])
def test_main_path_grouped_mix_calls_per_step(monkeypatch, name, det, k,
                                              comm, per_step):
    """The grouped ring-mix calls of the main path, with evaluation every
    step: ``chip_smoke.py`` holds the card's launch counts to these."""
    calls = {"ring": 0, "multi": 0, "quant": 0}

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ops, "ring_mix_leaves",
                        spy("ring", ops.ring_mix_leaves))
    monkeypatch.setattr(ops, "multi_hop_mix_leaves",
                        spy("multi", ops.multi_hop_mix_leaves))
    monkeypatch.setattr(ops, "quant_mix_leaves",
                        spy("quant", ops.quant_mix_leaves))
    steps = 2
    run_method(name, steps, det, image_hw=8, n_nodes=5, k_steps=k,
               eval_every=1, device="cpu", comm=comm)
    assert calls == {key: c * steps for key, c in per_step.items()}


@pytest.mark.parametrize("comm", [None, COMM_PRESETS["int8_ef"]])
def test_a_step_projects_every_stiefel_leaf_in_one_call(monkeypatch, comm):
    """A DRGDA step's Riemannian gradient projects fc1 and head through ONE
    ``stiefel_project_leaves`` call (one launch on the card), and an
    EF-int8 step's first hops are one grouped ``quant_mix_leaves`` call per
    tree, with no exact ring mix of the hats."""
    from repro_torch.launch.fair import prepare
    calls = {"project": [], "quant": 0, "ring": 0}
    grouped, quant, ring = (ops.stiefel_project_leaves, ops.quant_mix_leaves,
                            ops.ring_mix_leaves)

    def project_spy(xs, gs):
        calls["project"].append(tuple(x.shape for x in xs))
        return grouped(xs, gs)

    def count(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    run = prepare("drgda", True, image_hw=8, n_nodes=5, k_steps=1,
                  device="cpu", comm=comm)
    monkeypatch.setattr(ops, "stiefel_project_leaves", project_spy)
    monkeypatch.setattr(ops, "quant_mix_leaves", count("quant", quant))
    monkeypatch.setattr(ops, "ring_mix_leaves", count("ring", ring))
    state, _ = run.opt.step(run.state, run.full)
    shapes = [tuple(run.state.x[k].shape) for k in sorted(run.state.x)
              if k in ("fc1", "head")]
    assert calls["project"] == [tuple(shapes)]
    assert calls["quant"] == (4 if comm else 0)
    assert calls["ring"] == (0 if comm else 4)


def test_run_method_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_method("drgda", 1, True, image_hw=8, n_nodes=3)
