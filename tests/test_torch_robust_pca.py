"""The port's robust PCA (``repro_torch.objectives.robust_pca``) against the
JAX package's, on the same NumPy inputs: the data of the JAX package's
``make_batches`` (the port cannot reproduce ``jax.random`` draws), its
initial basis, Gr(12, 2), m = 10, n = 4.

Tolerances: the residuals, the loss and y* to 1e-6 (fp32 products in
another order); the loss at x and at x q (another basis of the same
subspace) to 1e-5; DRGDA's 10-step trajectory (the example's
hyper-parameters, gossip at the ring's Theorem-1 steps, k = 2) and GT-GDA's
5 steps within 1e-5 per step in loss, x and y, M_t within 1e-5 relative,
as the fair trajectories in ``tests/test_torch_fair.py``.  The port's own
sampler (a torch generator) is held by invariants.
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
from repro.core import gda as jgda  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.core.metric import convergence_metric as j_metric  # noqa: E402
from repro.geometry import GRASSMANN as JGR  # noqa: E402
from repro.objectives import robust_pca as jrp  # noqa: E402
from repro_torch.core import OPTIMIZERS  # noqa: E402
from repro_torch.core.gda import GDAHyper, broadcast_to_nodes  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.core.metric import convergence_metric  # noqa: E402
from repro_torch.geometry import GRASSMANN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import robust_pca as launch  # noqa: E402
from repro_torch.objectives import robust_pca as rp  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

N, D, R, M, RHO = 4, 12, 2, 10, 0.5
HYPER = dict(alpha=0.5, beta=0.1, eta=0.3)     # examples/robust_pca.py


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def data():
    batches, basis = jrp.make_batches(jax.random.PRNGKey(1), n_nodes=N, m=M,
                                      d=D, r=R, outlier_frac=0.1,
                                      outlier_scale=1.5)
    x0 = JGR.rand(jax.random.PRNGKey(0), D, R)
    return batches, basis, x0


def test_objective_matches_reference(data):
    batches, basis, x0 = data
    z = np.asarray(batches["z"])
    y = np.random.default_rng(2).dirichlet(np.ones(M), size=N).astype(
        np.float32)
    for x in (np.asarray(x0), np.asarray(basis)):
        np.testing.assert_allclose(
            _np(rp.residuals(_t(x), _t(z[0]))),
            np.asarray(jrp.residuals(jnp.asarray(x), jnp.asarray(z[0]))),
            atol=1e-6)
        for i in range(N):
            got = rp.robust_pca_loss({"w": _t(x)}, _t(y[i]), {"z": _t(z[i])},
                                     rho=RHO)
            want = jrp.robust_pca_loss({"w": jnp.asarray(x)},
                                       jnp.asarray(y[i]),
                                       {"z": jnp.asarray(z[i])}, rho=RHO)
            assert abs(float(got) - float(want)) <= 1e-6
        np.testing.assert_allclose(
            _np(rp.robust_pca_y_star({"w": _t(x)}, {"z": _t(z)}, rho=RHO)),
            np.asarray(jrp.robust_pca_y_star({"w": jnp.asarray(x)},
                                             {"z": jnp.asarray(z)},
                                             rho=RHO)), atol=1e-6)
    np.testing.assert_array_equal(_np(rp.init_y(N, M)),
                                  np.asarray(jrp.init_y(N, M)))


def test_loss_is_basis_invariant(data):
    batches, _, x0 = data
    x = _t(x0)
    q = torch.linalg.qr(torch.randn((R, R), generator=torch.Generator()
                                    .manual_seed(3)))[0]
    y = rp.init_y(N, M)[0]
    b = {"z": _t(batches["z"][0])}
    a = rp.robust_pca_loss({"w": x}, y, b, rho=RHO)
    c = rp.robust_pca_loss({"w": x @ q}, y, b, rho=RHO)
    assert abs(float(a) - float(c)) <= 1e-5
    assert float(GRASSMANN.dist(x, x @ q)) < 2e-3


def _pair(name, k=None):
    """The JAX package's optimizer ``name`` and the port's on robust PCA."""
    jopt = J_OPTIMIZERS[name](jrp.make_robust_pca_problem(rho=RHO),
                              JSpec(topology="ring", n_nodes=N, k_steps=k),
                              jgda.GDAHyper(**HYPER))
    topt = OPTIMIZERS[name](rp.make_robust_pca_problem(rho=RHO),
                            GossipSpec(topology="ring", n_nodes=N,
                                       k_steps=k), GDAHyper(**HYPER))
    return jopt, topt


@pytest.mark.parametrize("name,steps", [("drgda", 10), ("gt-gda", 5)])
def test_trajectory_matches_reference(data, name, steps):
    batches, _, x0 = data
    jopt, topt = _pair(name)
    tb = {"z": _t(batches["z"])}
    js = jopt.init(jgda.broadcast_to_nodes({"w": x0}, N), jrp.init_y(N, M),
                   batches)
    ts = topt.init(broadcast_to_nodes({"w": _t(x0)}, N), rp.init_y(N, M), tb)
    step = jax.jit(jopt.step)
    for t in range(steps):
        js, jm = step(js, batches)
        ts, tm = topt.step(ts, tb)
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        np.testing.assert_allclose(_np(ts.x["w"]), np.asarray(js.x["w"]),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), atol=1e-5)
    want = jax.jit(functools.partial(j_metric, jopt.problem))(js.x, js.y,
                                                             batches)
    got = convergence_metric(topt.problem, ts.x, ts.y, tb)
    assert abs(float(got["M_t"]) - float(want["M_t"])) <= 1e-5 * float(
        want["M_t"])
    assert float(got["stiefel_residual"]) < 1e-5


def test_port_sampler_invariants():
    """The port's ``make_batches``: shapes, an orthonormal basis, the
    outlier share within 5 sigma of its binomial mean, clean rows within the
    noise level of span(basis), and the same draws from the same seed."""
    n, m, d, r, noise, frac, scale = 20, 256, 64, 4, 0.05, 0.15, 3.0
    batches, basis = rp.make_batches(torch.Generator().manual_seed(0), n, m,
                                     d, r, noise=noise, outlier_frac=frac,
                                     outlier_scale=scale)
    z = batches["z"]
    assert tuple(z.shape) == (n, m, d) and tuple(basis.shape) == (d, r)
    assert float(GRASSMANN.check(basis)) < 1e-5
    off = torch.linalg.vector_norm(z - (z @ basis) @ basis.T, dim=-1)
    # off-span norm: noise * chi(d - r) for clean rows, scale * chi(d - r)
    # for outliers; the two bands are far apart at these settings
    clean_max = noise * (math.sqrt(d - r) + 5.0)
    outlier_min = scale * (math.sqrt(d - r) - 5.0)
    assert clean_max < outlier_min
    is_out = off > clean_max
    assert bool((off[is_out] > outlier_min).all())
    total = n * m
    mean, sigma = total * frac, math.sqrt(total * frac * (1 - frac))
    assert abs(int(is_out.sum()) - mean) <= 5 * sigma
    again, basis2 = rp.make_batches(torch.Generator().manual_seed(0), n, m,
                                    d, r, noise=noise, outlier_frac=frac,
                                    outlier_scale=scale)
    assert torch.equal(again["z"], z) and torch.equal(basis2, basis)
    other, _ = rp.make_batches(torch.Generator().manual_seed(1), n, m, d, r)
    assert not torch.equal(other["z"], z)
    fixed, kept = rp.make_batches(torch.Generator().manual_seed(2), 2, 8, d,
                                  r, subspace=basis)
    assert torch.equal(kept, basis)


@pytest.mark.parametrize("retraction", ["polar", "qr", "polar_fused"])
@pytest.mark.parametrize("k,per_step", [
    (1, {"ring": 4, "multi_hop": 0}),
    # Theorem 1 on a 4-node ring: k = 2 hops for x, y and u, one for v
    (None, {"ring": 1, "multi_hop": 3})])
def test_calls_per_step(monkeypatch, retraction, k, per_step):
    """The kernel wrappers a robust-PCA DRGDA step calls (each call one
    launch on the card): one grouped ring call per mixed tree, no Stiefel
    projection (the Grassmann projection is plain products) and no fused
    retraction under any retraction name (a Grassmann leaf resolves
    ``polar_fused`` to ``polar``).  ``chip_smoke.py`` holds the card's
    launch counts to these."""
    calls = dict.fromkeys(("ring", "multi_hop", "project", "fused"), 0)

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    for key, attr in (("ring", "ring_mix_leaves"),
                      ("multi_hop", "multi_hop_mix_leaves"),
                      ("project", "stiefel_project"),
                      ("project", "stiefel_project_leaves"),
                      ("fused", "fused_retract")):
        monkeypatch.setattr(ops, attr, spy(key, getattr(ops, attr)))
    gen = torch.Generator().manual_seed(0)
    batches, _ = rp.make_batches(gen, N, M, D, R)
    opt = OPTIMIZERS["drgda"](rp.make_robust_pca_problem(rho=RHO),
                              GossipSpec(n_nodes=N, k_steps=k),
                              GDAHyper(**HYPER, retraction=retraction))
    state = opt.init(broadcast_to_nodes(
        {"w": GRASSMANN.rand(D, R, generator=gen, device="cpu")}, N),
        rp.init_y(N, M), batches)
    convergence_metric(opt.problem, state.x, state.y, batches)
    assert calls == dict.fromkeys(calls, 0)
    for _ in range(2):
        state, _ = opt.step(state, batches)
    assert calls == {**{key: 2 * c for key, c in per_step.items()},
                     "project": 0, "fused": 0}


def test_launch_run_returns_the_example_record():
    """``launch.robust_pca.run`` at a cut size: the curve's points, the
    launches a step (none on the CPU), Phi and the four checks."""
    res = launch.run("example", steps=30, eval_every=10, device="cpu")
    assert [p["step"] for p in res["curve"]] == [0, 10, 20, 30]
    assert res["k"] == 8 and res["n_nodes"] == 8
    for p in res["curve"]:
        assert all(math.isfinite(p[k]) for k in ("loss", "M_t", "angle"))
        assert p["stiefel_residual"] < 1e-4
    assert set(res["checks"]) == set(launch.CHECKS)
    assert res["phi"]["drgda"] > 0 and res["phi"]["pca"] > 0
    assert sum(res["launches_per_step"].values()) == 0
    with pytest.raises(ValueError):
        launch.run("example", steps=1, device="cpu",
                   x0=torch.zeros(5, 3), batches={"z": torch.zeros(8, 24,
                                                                   20)},
                   true_basis=torch.zeros(20, 3))
