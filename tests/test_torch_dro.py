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
