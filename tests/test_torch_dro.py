"""The DRO experiment (paper Eq. 21, ``benchmarks/dro.py``) in the port
against the JAX package: ``make_dro_problem`` on the fair CNN at n = 4, 8x8
images, the stream at ``hetero=0.9``, the same NumPy batches and the JAX
package's initial weights (``repro_torch.convert``).

Tolerances, as for the fair trajectories (``tests/test_torch_fair.py``,
``tests/test_torch_baselines.py``): DRSGDA, GNSD-A and DM-HSGD at the
benchmark's hyper-parameters follow the JAX package's 10-step trajectories
within 1e-5 per step in loss, every x leaf and y, and 1e-5 relative in the
final M_t.  No gossip draws are involved (exact gossip).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import OPTIMIZERS as J_OPTIMIZERS  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core import gda as jgda  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.core.metric import convergence_metric as j_metric  # noqa: E402
from repro.data.synthetic import ClassificationStream as JStream  # noqa: E402
from repro.objectives import fair as jfair  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import OPTIMIZERS  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.core.metric import convergence_metric  # noqa: E402
from repro_torch.launch import dro  # noqa: E402
from repro_torch.objectives import fair  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

N, HW, FC = 4, 8, 16
J_HYPER = {"dm-hsgd": jb.HSGDHyper(beta=0.05, eta=0.2),
           "drsgda": jgda.GDAHyper(alpha=0.5, beta=0.05, eta=0.2),
           "gnsd-a": jgda.GDAHyper(alpha=0.5, beta=0.05, eta=0.2)}


def _np(t):
    return t.detach().cpu().numpy()


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def setup():
    params = jfair.init_cnn(jax.random.PRNGKey(0), image_hw=HW, fc=FC)
    stream = JStream(n_nodes=N, batch_per_node=8, image_hw=HW, seed=0,
                     hetero=dro.HETERO)
    return params, stream


@pytest.mark.parametrize("name", dro.METHODS)
def test_trajectory_matches_reference(setup, name):
    params, stream = setup
    spec = dict(topology="ring", n_nodes=N, k_steps=1)
    jopt = J_OPTIMIZERS[name](jfair.make_dro_problem(params), JSpec(**spec),
                              J_HYPER[name])
    topt = OPTIMIZERS[name](fair.make_dro_problem({}), GossipSpec(**spec),
                            dro.hyper(name))
    x0 = jgda.broadcast_to_nodes(params, N)
    b0 = stream.batch(0)
    js = jopt.init(x0, jnp.full((N, 3), 1.0 / 3.0), _jbatch(b0))
    ts = topt.init(convert.params_from_reference(x0, "cpu"),
                   torch.full((N, 3), 1.0 / 3.0),
                   convert.batch_to_torch(b0, "cpu"))
    step = jax.jit(jopt.step)
    for t in range(10):
        b = stream.batch(t + 1)
        js, jm = step(js, _jbatch(b))
        ts, tm = topt.step(ts, convert.batch_to_torch(b, "cpu"))
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        tx = convert.params_to_reference(ts.x)
        for key in tx:
            np.testing.assert_allclose(tx[key], np.asarray(js.x[key]),
                                       atol=1e-5)
        np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), atol=1e-5)
    full = stream.full(2)
    want = float(jax.jit(functools.partial(j_metric, jopt.problem))(
        js.x, js.y, _jbatch(full))["M_t"])
    got = float(convergence_metric(topt.problem, ts.x, ts.y,
                                   convert.batch_to_torch(full, "cpu"))
                ["M_t"])
    assert abs(got - want) <= 1e-5 * want


def test_run_method_follows_the_benchmarks_loop():
    """``launch.dro.run_method`` against the benchmark's own
    ``run_method`` (``benchmarks/dro.py``, at n = 4 and fc = 16 through its
    ``N_NODES`` and ``init_cnn``), from the same weights, 10 steps: the same
    curve points (after the first step and every 10th) to 1e-5 relative in
    loss, M_t and the worst group's weight; x on the manifold."""
    import _reference_curves as rc

    bench = rc.benchmark("dro")
    bench.N_NODES = N
    init = bench.fair.init_cnn
    bench.fair.init_cnn = lambda key, image_hw: init(key, image_hw=image_hw,
                                                     fc=FC)
    try:
        want = bench.run_method("drsgda", 10)["curve"]
        params = bench.fair.init_cnn(jax.random.PRNGKey(0), image_hw=14)
    finally:
        bench.fair.init_cnn = init
    got = dro.run_method("drsgda", 10, device="cpu", n_nodes=N,
                         params=convert.params_from_reference(params, "cpu"))
    assert [p["step"] for p in got["curve"]] == [p["step"] for p in want] \
        == [1, 10]
    for a, b in zip(got["curve"], want):
        for key in ("loss", "M_t", "worst_group_weight"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), key
        assert a["stiefel_residual"] < 1e-5
    assert math.isfinite(got["us_per_step"])


def test_gnsd_a_parts_from_the_reference_at_a_relu_kink():
    """Why the port's GNSD-A leaves the JAX package's DRO curve after
    step 10 on the CPU (the reference's settings: 20-node ring, 14x14, 32
    per node, ``hetero=0.9``): not a port fault but a kink of the model.

    After 10 steps the two packages' states agree to rounding (x within
    1e-6), yet one conv2 ReLU input, node 10's first sample at row 1,
    column 3, channel 0, lies within 1e-6 of zero and takes opposite signs
    in the two states.  Fed to the JAX package's gradient (on the step's
    batch) the two states give gradients that agree to 1e-5 everywhere
    but in node 10's conv kernels, where the kink moves the conv2 gradient
    by more than 1e-4; and from the port's state, the port's gradient agrees with the
    JAX package's to 1e-6.  The curves part from there on."""
    from repro.core.baselines import _euclid_grads as j_grads
    from repro_torch.core.baselines import _euclid_grads as t_grads

    n, steps = dro.N_NODES, 10
    params = jfair.init_cnn(jax.random.PRNGKey(0), image_hw=14)
    stream = JStream(n_nodes=n, batch_per_node=dro.BATCH_PER_NODE, seed=0,
                     hetero=dro.HETERO)
    spec = dict(topology="ring", n_nodes=n, k_steps=1)
    jopt = J_OPTIMIZERS["gnsd-a"](jfair.make_dro_problem(params),
                                  JSpec(**spec), J_HYPER["gnsd-a"])
    topt = OPTIMIZERS["gnsd-a"](fair.make_dro_problem({}),
                                GossipSpec(**spec), dro.hyper("gnsd-a"))
    x0 = jgda.broadcast_to_nodes(params, n)
    b0 = stream.batch(0)
    js = jax.jit(jopt.init)(x0, jnp.full((n, 3), 1.0 / 3.0), _jbatch(b0))
    ts = topt.init(convert.params_from_reference(x0, "cpu"),
                   torch.full((n, 3), 1.0 / 3.0),
                   convert.batch_to_torch(b0, "cpu"))
    step = jax.jit(jopt.step)
    for t in range(steps):
        b = stream.batch(t + 1)
        js, _ = step(js, _jbatch(b))
        ts, _ = topt.step(ts, convert.batch_to_torch(b, "cpu"))
    tx = {k: jnp.asarray(v)
          for k, v in convert.params_to_reference(ts.x).items()}
    for key in tx:
        np.testing.assert_allclose(np.asarray(tx[key]), np.asarray(js.x[key]),
                                   atol=1e-6)

    # the conv2 ReLU inputs of every node and sample, on step 10's batch
    images = jnp.asarray(stream.batch(steps)["images"])

    def conv2_input(p, im):
        dn = ("NHWC", "HWIO", "NHWC")
        h = jax.lax.conv_general_dilated(im, p["conv1"], (1, 1), "SAME",
                                         dimension_numbers=dn)
        h = jax.lax.reduce_window(jax.nn.relu(h), -jnp.inf, jax.lax.max,
                                  (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        return jax.lax.conv_general_dilated(h, p["conv2"], (1, 1), "SAME",
                                            dimension_numbers=dn)

    pre = jax.jit(jax.vmap(conv2_input))
    a, b = np.asarray(pre(js.x, images)), np.asarray(pre(tx, images))
    flips = [tuple(int(i) for i in f) for f in np.argwhere((a > 0) != (b > 0))]
    assert flips == [(10, 0, 1, 3, 0)]          # (node, sample, row, col, ch)
    assert max(abs(a[flips[0]]), abs(b[flips[0]])) < 1e-6

    batch = _jbatch(stream.batch(steps))
    grads = jax.jit(lambda x, y: j_grads(jopt.problem, x, y, batch)[1][0])
    g_ref, g_port = grads(js.x, js.y), grads(tx, jnp.asarray(_np(ts.y)))
    for key in g_ref:
        d = np.abs(np.asarray(g_ref[key]) - np.asarray(g_port[key])).reshape(
            n, -1).max(1)
        if key == "conv2":
            assert d[10] > 1e-4, d[10]
        if key.startswith("conv"):
            # the flipped unit's gradient flows into both conv kernels of
            # node 10; fc1 and head see its output, which is within 1e-6
            d = np.delete(d, 10)
        assert d.max() <= 1e-5, (key, d.max())
    _, t_gx, _ = t_grads(topt.problem, ts.x, ts.y,
                         convert.batch_to_torch(stream.batch(steps), "cpu"))
    t_gx = convert.params_to_reference(t_gx)
    for key in t_gx:
        np.testing.assert_allclose(t_gx[key], np.asarray(g_port[key]),
                                   atol=1e-6)
