"""The port's geometry and gossip against ``repro.geometry`` and
``repro.core.gossip``, on the same NumPy inputs.

Tolerances: 1e-6 absolute for the projections and retractions at unit
scale (fp32 products summed in another order); the retraction axioms use
the JAX package's own bounds (``tests/test_geometry.py``).  A DRGDA
trajectory under the Cayley retraction holds 1e-5 over 10 steps, as the
polar ones do in ``tests/test_torch_fair.py``.  Ring mixes are
bitwise against the JAX package's eager ring expression; the JAX
``mix_ring`` runs under ``jit``, where XLA:CPU contracts each hop into one
FMA, so against it they hold to ``steps * eps32 * max|x|`` (the hop is
non-expansive in the max norm).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as jg  # noqa: E402
from repro.core.minimax import project_simplex as j_project_simplex  # noqa: E402
from repro.geometry import stiefel as jst  # noqa: E402
from repro_torch import geometry as G  # noqa: E402
from repro_torch.core import gossip as tg  # noqa: E402
from repro_torch.core.minimax import project_simplex  # noqa: E402
from repro_torch.geometry import stiefel as tst  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().cpu().numpy()


def _stiefel(rng, shape):
    return np.linalg.qr(rng.normal(size=shape))[0].astype(np.float32)


# ---------------------------------------------------------------------------
# Stiefel geometry vs the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(30, 4), (3, 20, 5), (64, 3)])
def test_stiefel_ops_match_reference(shape):
    rng = np.random.default_rng(shape[-1])
    x = _stiefel(rng, shape)
    g = rng.normal(size=shape).astype(np.float32)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    u = np.asarray(jst.tangent_project(xj, gj))
    np.testing.assert_allclose(_np(tst.tangent_project(_t(x), _t(g))), u,
                               atol=1e-6)
    step = 0.3 * u / np.linalg.norm(u)
    for method in ("ns", "eigh"):
        np.testing.assert_allclose(
            _np(tst.retract_polar(_t(x), _t(step), method=method)),
            np.asarray(jst.retract_polar(xj, jnp.asarray(step), method)),
            atol=1e-6)
    np.testing.assert_allclose(_np(tst.retract_qr(_t(x), _t(step))),
                               np.asarray(jst.retract_qr(xj, jnp.asarray(step))),
                               atol=1e-6)
    a = (x + 0.05 * g).astype(np.float32)
    for method in ("ns", "eigh"):
        np.testing.assert_allclose(
            _np(tst.project_stiefel(_t(a), method)),
            np.asarray(jst.project_stiefel(jnp.asarray(a), method)),
            atol=1e-6)
    np.testing.assert_allclose(_np(tst.stiefel_error(_t(a))),
                               np.asarray(jst.stiefel_error(jnp.asarray(a))),
                               atol=1e-6)


def test_induced_arithmetic_mean_matches_reference():
    rng = np.random.default_rng(3)
    base = _stiefel(rng, (24, 5))
    xs = (base + 0.05 * rng.normal(size=(6, 24, 5))).astype(np.float32)
    for method in ("ns", "eigh"):
        np.testing.assert_allclose(
            _np(tst.induced_arithmetic_mean(_t(xs), method)),
            np.asarray(jst.induced_arithmetic_mean(jnp.asarray(xs), method)),
            atol=1e-6)
        np.testing.assert_allclose(
            _np(G.get("stiefel").consensus_mean(_t(xs), method)),
            np.asarray(jst.induced_arithmetic_mean(jnp.asarray(xs), method)),
            atol=1e-6)


def test_feasible_init_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(40, 7)).astype(np.float32)
    from repro.geometry import get as jget
    want = np.asarray(jget("stiefel").feasible_init(jnp.asarray(a)))
    np.testing.assert_allclose(_np(G.get("stiefel").feasible_init(_t(a))),
                               want, atol=1e-5)


@pytest.mark.parametrize("name,kind", [("stiefel", "polar"),
                                       ("stiefel", "qr"),
                                       ("stiefel", "cayley"),
                                       ("euclidean", "add")])
def test_retraction_axioms(name, kind):
    """R_x(0) = x, R_x(u) feasible, R_x(tu) = x + tu + O(t^2)."""
    m = G.get(name)
    rng = np.random.default_rng(11)
    for _ in range(12):
        d = int(rng.integers(3, 49))
        r = int(rng.integers(1, min(d, 12) + 1))
        gen = torch.Generator().manual_seed(int(rng.integers(2 ** 16)))
        x = m.rand(d, r, generator=gen, device="cpu")
        u = m.tangent_project(x, torch.randn((d, r), generator=gen))
        u = 0.2 * u / u.norm().clamp_min(1e-9)
        np.testing.assert_allclose(_np(m.retract(x, torch.zeros_like(x),
                                                 kind)), _np(x), atol=1e-5)
        assert float(m.check(m.retract(x, u, kind)).max()) < 1e-5
        for t in (0.5, 0.25):
            resid = float((m.retract(x, t * u, kind) - (x + t * u)).norm())
            assert resid <= 8.0 * float(((t * u) ** 2).sum()) + 1e-5


def test_polar_fused_equals_descent_update_at_the_leaf():
    """The fused path with the ambient direction == projection then polar."""
    m = G.get("stiefel")
    rng = np.random.default_rng(2)
    x = _t(_stiefel(rng, (4, 30, 6)))
    mx = x + 0.05 * _t(rng.normal(size=(4, 30, 6)))
    u = 0.2 * _t(rng.normal(size=(4, 30, 6)))
    fused = m.retract(x, 0.5 * mx - 0.05 * u, "polar_fused")
    plain = m.descent_update(x, mx, u, alpha=0.5, beta=0.05, kind="polar",
                             method="eigh")
    np.testing.assert_allclose(_np(fused), _np(plain), atol=5e-5)


def test_retraction_names():
    assert G.check_retraction_name("polar_fused") == "polar_fused"
    # every retraction of the JAX package's Stiefel geometry runs
    assert G.check_retraction_name("cayley") == "cayley"
    assert set(G.get("stiefel").retractions) == set(
        jst.Stiefel.retractions)
    with pytest.raises(ValueError, match="unknown retraction"):
        G.check_retraction_name("polr")
    mm = G.as_manifold_map({"a": "stiefel", "b": G.get("euclidean")})
    assert mm["a"].name == "stiefel" and mm["b"].name == "euclidean"
    assert mm["b"].resolve_retraction("polar_fused") == "add"


@pytest.mark.parametrize("solver", ["cg", "neumann"])
def test_retract_cayley_matches_reference(solver):
    """W applied in its low-rank form, CG or Neumann: the JAX package's
    ``retract_cayley`` to 1e-6 at (4, 16, 5), and on St(d, r) to 1e-5."""
    rng = np.random.default_rng(5)
    x = _stiefel(rng, (4, 16, 5))
    u = np.asarray(jst.tangent_project(
        jnp.asarray(x), jnp.asarray(rng.normal(size=x.shape), jnp.float32)))
    u = (0.3 * u / np.linalg.norm(u, axis=(-2, -1), keepdims=True)
         ).astype(np.float32)
    for iters in (None, 4):
        kw = {"iters": iters} if iters else {}
        got = tst.retract_cayley(_t(x), _t(u), solver=solver, **kw)
        want = np.asarray(jst.retract_cayley(jnp.asarray(x), jnp.asarray(u),
                                             solver=solver, **kw))
        np.testing.assert_allclose(_np(got), want, atol=1e-6)
        via = G.get("stiefel").retract(_t(x), _t(u), "cayley", solver=solver,
                                       iters=iters)
        np.testing.assert_array_equal(_np(via), _np(got))
    assert float(tst.stiefel_error(got).max()) <= 1e-5


def test_drgda_cayley_trajectory_matches_reference():
    """DRGDA with ``retraction="cayley"`` over 10 steps on the fair CNN
    (n = 4, 8x8 images): loss, every x leaf and y within 1e-5 of the JAX
    package, the final M_t within 1e-5 relative."""
    from repro.core import OPTIMIZERS as J_OPTIMIZERS
    from repro.core import gda as jgda
    from repro.core.metric import convergence_metric as j_metric
    from repro.data.synthetic import ClassificationStream
    from repro.objectives import fair as jfair
    from repro_torch import convert
    from repro_torch.core import OPTIMIZERS
    from repro_torch.core.gda import GDAHyper
    from repro_torch.core.metric import convergence_metric
    from repro_torch.objectives import fair

    n = 4
    params = jfair.init_cnn(jax.random.PRNGKey(0), image_hw=8, fc=16)
    full = ClassificationStream(n_nodes=n, batch_per_node=8, image_hw=8,
                                seed=0).full(2)
    jfull = {k: jnp.asarray(v) for k, v in full.items()}
    tfull = convert.batch_to_torch(full, "cpu")
    hyper = dict(alpha=0.5, beta=0.05, eta=0.2, retraction="cayley")
    jprob, tprob = jfair.make_fair_problem(params), fair.make_fair_problem({})
    jopt = J_OPTIMIZERS["drgda"](jprob, jg.GossipSpec(n_nodes=n, k_steps=1),
                                 jgda.GDAHyper(**hyper))
    topt = OPTIMIZERS["drgda"](tprob, tg.GossipSpec(n_nodes=n, k_steps=1),
                               GDAHyper(**hyper))
    x0 = jgda.broadcast_to_nodes(params, n)
    js = jopt.init(x0, jnp.full((n, 3), 1.0 / 3.0), jfull)
    ts = topt.init(convert.params_from_reference(x0, "cpu"),
                   torch.full((n, 3), 1.0 / 3.0), tfull)
    step = jax.jit(jopt.step)
    for t in range(10):
        js, jm = step(js, jfull)
        ts, tm = topt.step(ts, tfull)
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        tx = convert.params_to_reference(ts.x)
        for key in tx:
            np.testing.assert_allclose(tx[key], np.asarray(js.x[key]),
                                       atol=1e-5)
        np.testing.assert_allclose(_np(ts.y), np.asarray(js.y), atol=1e-5)
    want = float(jax.jit(lambda x, y: j_metric(jprob, x, y, jfull))(
        js.x, js.y)["M_t"])
    got = convergence_metric(tprob, ts.x, ts.y, tfull)
    assert abs(float(got["M_t"]) - want) <= 1e-5 * want
    assert float(got["stiefel_residual"]) <= 1e-5


def test_project_simplex_matches_reference():
    rng = np.random.default_rng(0)
    y = (2.0 * rng.normal(size=(9, 5))).astype(np.float32)
    np.testing.assert_allclose(_np(project_simplex(_t(y))),
                               np.asarray(j_project_simplex(jnp.asarray(y))),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# gossip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology,n", [("ring", 2), ("ring", 20),
                                        ("full", 6), ("torus", 12),
                                        ("star", 5)])
def test_mixing_matrices_and_theorem1_steps(topology, n):
    spec = tg.GossipSpec(topology=topology, n_nodes=n)
    ref = jg.GossipSpec(topology=topology, n_nodes=n)
    np.testing.assert_array_equal(spec.matrix, ref.matrix)
    assert spec.k == ref.k
    assert spec.lam2 == ref.lam2


def test_theorem1_steps_of_the_paper_ring():
    assert tg.GossipSpec(n_nodes=20).k == 67


@pytest.mark.parametrize("n", [2, 3, 5, 20])
@pytest.mark.parametrize("steps", [1, 3])
def test_ring_mix_matches_reference(n, steps):
    rng = np.random.default_rng(n * 10 + steps)
    tree = {"a": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 7)).astype(np.float32)}
    spec = tg.GossipSpec(n_nodes=n, k_steps=steps)
    got = {k: _np(v) for k, v in spec.mix({k: _t(v) for k, v in tree.items()}
                                          ).items()}
    want = jg.GossipSpec(n_nodes=n, k_steps=steps).mix(
        {k: jnp.asarray(v) for k, v in tree.items()})
    plain = tg.mix_ring({k: _t(v) for k, v in tree.items()}, steps=steps)
    for k in tree:
        bound = steps * EPS32 * float(np.abs(tree[k]).max())
        assert np.abs(got[k] - np.asarray(want[k])).max() <= bound
        np.testing.assert_array_equal(got[k], _np(plain[k]))
        if n > 2:   # the JAX package's ring expression, eagerly: bitwise
            z = jnp.asarray(tree[k])
            for _ in range(steps):
                z = jg._mix_leaf_ring(z, 1.0 / 3.0, 1.0 / 3.0)
            np.testing.assert_array_equal(got[k], np.asarray(z))


@pytest.mark.parametrize("topology", ["full", "torus"])
def test_dense_mix_matches_reference(topology):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    spec = tg.GossipSpec(topology=topology, n_nodes=12, k_steps=2)
    got = _np(spec.mix({"x": _t(x)})["x"])
    want = np.asarray(jg.GossipSpec(topology=topology, n_nodes=12,
                                    k_steps=2).mix({"x": jnp.asarray(x)})["x"])
    np.testing.assert_allclose(got, want, atol=1e-6)
    w = _t(spec.matrix)
    np.testing.assert_allclose(_np(tg.mix_dense(w, {"x": _t(x)}, 2)["x"]),
                               want, atol=1e-6)


@pytest.mark.parametrize("d, r", [(1024, 64), (1100, 48)])
def test_polar_long_reductions_are_chunked(d, r):
    """``retract_polar`` sums a reduction above ``ref.LONG_K`` in chunks of
    ``ref.CHUNK_K`` (a card's whole fp32 reductions at k = 2048 left the
    retraction several times less orthonormal than the CPU's): up to
    LONG_K it is bitwise the whole-reduction formula; above it the Gram
    is bitwise the chunked sum, and the result is the JAX package's
    within 1e-5 and the fp64 retraction's within 2e-5; ``ref.matmul``
    (the Newton-Schulz products) is bitwise the chunked sum above LONG_K
    and the plain product up to it."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(d + r)
    x = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    xt = torch.from_numpy(x)
    u = ref.stiefel_project_ref(xt, 1e-2 * torch.from_numpy(
        rng.standard_normal((d, r)).astype(np.float32)))
    got = tst.retract_polar(xt, u)
    utu = torch.einsum("...dr,...ds->...rs", u, u)
    if d <= ref.LONG_K:
        inv = tst.invsqrt_spd(torch.eye(r) + utu)
        want = torch.einsum("...dr,...rs->...ds", xt + u, inv)
        assert torch.equal(got, want)
        return
    parts = [u[k0:k0 + ref.CHUNK_K] for k0 in range(0, d, ref.CHUNK_K)]
    gram = torch.einsum("dr,ds->rs", parts[0], parts[0])
    for p in parts[1:]:
        gram = gram + torch.einsum("dr,ds->rs", p, p)
    assert torch.equal(tst._gram(u), gram)
    jgot = jst.retract_polar(jnp.asarray(x), jnp.asarray(u.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5,
                               rtol=0)
    exact = tst.retract_polar(xt.double(), u.double())
    assert float((got.double() - exact).abs().max()) < 2e-5
    a = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((d, 5)).astype(np.float32))
    want = a[:, :ref.CHUNK_K] @ b[:ref.CHUNK_K]
    for k0 in range(ref.CHUNK_K, d, ref.CHUNK_K):
        want = want + a[:, k0:k0 + ref.CHUNK_K] @ b[k0:k0 + ref.CHUNK_K]
    assert torch.equal(ref.matmul(a, b), want)
    assert torch.equal(ref.matmul(a[:, :ref.LONG_K], b[:ref.LONG_K]),
                       a[:, :ref.LONG_K] @ b[:ref.LONG_K])
