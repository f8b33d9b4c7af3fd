"""The port's Grassmann, oblique, sphere and product geometries against the
JAX package's ``repro.geometry``, on the same NumPy inputs.

Tolerances: 1e-6 absolute for every op at unit scale (fp32 products summed
in another order); 1e-4 absolute for ``dist`` (a principal angle near 0 is
arccos of a singular value near 1, and fp32 rounding moves it by about
5e-4 at 0: the test's points keep their angles away from 0, where the
rounding is of the order of 1e-6).  The retraction axioms use the JAX
package's own bounds (``tests/test_geometry.py``), at fixed seeds.

Gr(d, r) is held to the axioms for d > r only: on Gr(d, d) the horizontal
space is {0}, so there is no tangent step to retract along.  Scaling the
projection's rounding noise to a fixed norm, as the JAX package's own
axiom test does when it draws d == r (its falsifying example
``drs=(3, 3, 0)``), gives a direction that is not horizontal, and the
polar identity behind the retraction fails.  The case d == r has its own
test: the projection of any g is within 1e-5 ||g|| of zero.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import geometry as JG  # noqa: E402
from repro.core.minimax import MinimaxProblem as JProblem  # noqa: E402
from repro.core.minimax import validate_manifold as j_validate  # noqa: E402
from repro.geometry import grassmann as jgr  # noqa: E402
from repro_torch import geometry as G  # noqa: E402
from repro_torch.core import manifolds as M  # noqa: E402
from repro_torch.core.minimax import (MinimaxProblem,  # noqa: E402
                                      project_simplex, validate_manifold)
from repro_torch.geometry import grassmann as tgr  # noqa: E402

NEW = ("grassmann", "oblique", "sphere")
SHAPES = [(12, 3), (30, 7), (4, 24, 5), (64, 1)]
ATOL, DIST_ATOL = 1e-6, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().cpu().numpy()


def _point(name, rng, shape):
    """A point of geometry ``name`` from NumPy draws (both packages take
    the same array)."""
    a = rng.normal(size=shape)
    if name == "grassmann":
        return np.linalg.qr(a)[0].astype(np.float32)
    if name == "oblique":
        return (a / np.linalg.norm(a, axis=-2, keepdims=True)).astype(
            np.float32)
    return (a / np.linalg.norm(a, axis=(-2, -1), keepdims=True)).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol)


# ---------------------------------------------------------------------------
# every op against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NEW)
def test_ops_match_reference(name, shape):
    m, jm = G.get(name), JG.get(name)
    rng = np.random.default_rng(shape[-1] * 7 + len(name))
    x, y = _point(name, rng, shape), _point(name, rng, shape)
    g = rng.normal(size=shape).astype(np.float32)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    u = np.asarray(jm.tangent_project(xj, gj))
    _close(m.tangent_project(_t(x), _t(g)), u)
    step = (0.3 * u / np.linalg.norm(u)).astype(np.float32)
    for kind in m.retractions:
        _close(m.retract(_t(x), _t(step), kind),
               jm.retract(xj, jnp.asarray(step), kind))
    a = (x + 0.05 * g).astype(np.float32)
    _close(m.project(_t(a)), jm.project(jnp.asarray(a)))
    _close(m.feasible_init(_t(a)), jm.feasible_init(jnp.asarray(a)),
           atol=1e-5 if name == "grassmann" else ATOL)
    _close(m.check(_t(a)), jm.check(jnp.asarray(a)))
    _close(m.check(_t(x)), jm.check(xj))
    _close(m.dist(_t(x), _t(y)), jm.dist(xj, jnp.asarray(y)), DIST_ATOL)


@pytest.mark.parametrize("name", NEW)
def test_consensus_mean_matches_reference(name):
    m, jm = G.get(name), JG.get(name)
    rng = np.random.default_rng(3)
    base = _point(name, rng, (24, 5))
    xs = (base + 0.05 * rng.normal(size=(6, 24, 5))).astype(np.float32)
    for method in ("ns", "eigh"):
        _close(m.consensus_mean(_t(xs), method),
               jm.consensus_mean(jnp.asarray(xs), method))


def test_principal_angles_and_horizontal_projection_match_reference():
    rng = np.random.default_rng(8)
    x, y = _point("grassmann", rng, (3, 40, 6)), _point("grassmann", rng,
                                                        (3, 40, 6))
    g = rng.normal(size=(3, 40, 6)).astype(np.float32)
    _close(tgr.principal_angles(_t(x), _t(y)),
           jgr.principal_angles(jnp.asarray(x), jnp.asarray(y)), DIST_ATOL)
    _close(tgr.horizontal_project(_t(x), _t(g)),
           jgr.horizontal_project(jnp.asarray(x), jnp.asarray(g)))
    # no symmetrization: x^T P(g) = 0 exactly (to rounding), unlike Stiefel
    assert float((_t(x).transpose(-1, -2)
                  @ tgr.horizontal_project(_t(x), _t(g))).abs().max()) < 1e-5


@pytest.mark.parametrize("name", sorted(G.REGISTRY))
def test_resolve_retraction_matches_reference(name):
    m, jm = G.get(name), JG.get(name)
    assert m.retractions == jm.retractions
    assert m.requires_tall == jm.requires_tall
    assert m.fused_retraction == jm.fused_retraction
    for kind in ("polar", "qr", "cayley", "polar_fused", "normalize", "add",
                 "bogus", None):
        assert m.resolve_retraction(kind) == jm.resolve_retraction(kind)


def test_registry_holds_every_geometry():
    assert sorted(G.REGISTRY) == sorted(JG.REGISTRY) == [
        "euclidean", "grassmann", "oblique", "sphere", "stiefel"]
    assert G.GRASSMANN.fused_retraction is None


@pytest.mark.parametrize("manifold", sorted(G.REGISTRY))
def test_manifold_map_from_paths_matches_reference(manifold):
    shapes = {"layers": {"wq": (16, 4), "wide": (4, 16), "b": (4,)},
              "emb": (10, 6), "head": (3, 3, 2)}

    def tree(zeros, spec):
        return {k: tree(zeros, v) if isinstance(v, dict) else zeros(v)
                for k, v in spec.items()}

    paths = []

    def pred(path):
        paths.append(path)
        return path != "emb"

    got = G.manifold_map_from_paths(tree(torch.zeros, shapes), pred,
                                    manifold)
    mine, paths[:] = sorted(paths), []
    want = JG.manifold_map_from_paths(tree(jnp.zeros, shapes), pred,
                                      manifold)
    assert mine == sorted(paths)
    assert "layers/wq" in mine

    def names(t):
        return {k: names(v) if isinstance(v, dict) else v.name
                for k, v in t.items()}

    assert names(got) == names(want)
    tall = G.get(manifold).requires_tall
    assert got["layers"]["wide"].name == ("euclidean" if tall or manifold
                                          == "euclidean" else manifold)
    assert got["layers"]["b"].name == got["emb"].name == "euclidean"


# ---------------------------------------------------------------------------
# Product, validate_manifold and Problem.manifold
# ---------------------------------------------------------------------------

PRODUCT = {"g": "grassmann", "o": "oblique", "s": "sphere", "w": "stiefel",
           "e": "euclidean"}
LIKE = {"g": (2, 16, 4), "o": (2, 5, 9), "s": (2, 6, 2), "w": (2, 20, 3),
        "e": (2, 3, 3)}


def _tree(rng):
    x = {k: _point({"w": "grassmann", "e": "oblique"}.get(k, PRODUCT[k]),
                   rng, shape) for k, shape in LIKE.items()}
    x["e"] = rng.normal(size=LIKE["e"]).astype(np.float32)
    return x


def test_product_ops_match_reference():
    pm, jpm = G.Product(PRODUCT), JG.Product(PRODUCT)
    rng = np.random.default_rng(21)
    x, y = _tree(rng), _tree(rng)
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in x.items()}
    tx, ty, tg = ({k: _t(v) for k, v in t.items()} for t in (x, y, g))
    jx, jy, jg = ({k: jnp.asarray(v) for k, v in t.items()}
                  for t in (x, y, g))

    def close(got, want, atol=ATOL):
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k], atol)

    u = pm.tangent_project(tx, tg)
    close(u, jpm.tangent_project(jx, jg))
    step = {k: 0.1 * v for k, v in u.items()}
    for kind in ("polar", "qr", "cayley", "normalize", None):
        close(pm.retract(tx, step, kind),
              jpm.retract(jx, {k: jnp.asarray(_np(v))
                               for k, v in step.items()}, kind))
    a = {k: v + 0.05 * g[k] for k, v in x.items()}
    close(pm.project({k: _t(v) for k, v in a.items()}),
          jpm.project({k: jnp.asarray(v) for k, v in a.items()}))
    close(pm.feasible_init({k: _t(v) for k, v in a.items()}),
          jpm.feasible_init({k: jnp.asarray(v) for k, v in a.items()}),
          1e-5)
    close(pm.consensus_mean(tx), jpm.consensus_mean(jx))
    close(pm.consensus_step(tx, ty, 0.5), jpm.consensus_step(jx, jy, 0.5))
    _close(pm.check(tx), jpm.check(jx))
    _close(pm.check({k: _t(v) for k, v in a.items()}),
           jpm.check({k: jnp.asarray(v) for k, v in a.items()}))
    _close(pm.dist(tx, ty), jpm.dist(jx, jy), DIST_ATOL)
    assert repr(pm) == repr(jpm)


def test_product_rand_draws_the_leaves_in_flatten_order():
    pm = G.Product(PRODUCT)
    like = {k: torch.zeros(v) for k, v in LIKE.items()}
    x = pm.rand(like, generator=torch.Generator().manual_seed(4),
                device="cpu")
    assert {k: tuple(v.shape) for k, v in x.items()} == LIKE
    assert float(pm.check(x)) < 1e-5
    gen = torch.Generator().manual_seed(4)
    for k in sorted(LIKE):
        d, r = LIKE[k][-2:]
        want = G.get(PRODUCT[k]).rand(d, r, LIKE[k][:-2], generator=gen,
                                      device="cpu")
        torch.testing.assert_close(x[k], want, rtol=0, atol=0)


def test_validate_manifold_and_problem_manifold_match_reference():
    rng = np.random.default_rng(5)
    x = _tree(rng)
    bad = {k: 1.5 * v for k, v in x.items()}
    for params in (x, bad):
        _close(validate_manifold({k: _t(v) for k, v in params.items()},
                                 PRODUCT),
               j_validate({k: jnp.asarray(v) for k, v in params.items()},
                          PRODUCT))
    assert float(validate_manifold({"e": torch.ones(3, 3)},
                                   {"e": "euclidean"})) == 0.0
    prob = MinimaxProblem(loss_fn=lambda x, y, b: 0.0,
                          project_y=project_simplex, manifold_map=PRODUCT)
    jprob = JProblem(loss_fn=lambda x, y, b: 0.0, project_y=lambda y: y,
                     manifold_map=PRODUCT)
    assert isinstance(prob.manifold, G.Product)
    assert {k: m.name for k, m in prob.manifold.map.items()} == PRODUCT
    assert repr(prob.manifold) == repr(jprob.manifold)
    _close(prob.manifold.check({k: _t(v) for k, v in bad.items()}),
           jprob.manifold.check({k: jnp.asarray(v) for k, v in bad.items()}))


# ---------------------------------------------------------------------------
# the axioms, at fixed seeds
# ---------------------------------------------------------------------------

# d > r for Grassmann (see the module docstring); the norm geometries also
# take a wide leaf
AXIOM_CASES = [(name, kind, shape) for name in NEW
               for kind in G.get(name).retractions
               for shape in [(5, 2), (12, 3), (30, 7), (48, 12)]
               + ([] if G.get(name).requires_tall else [(4, 9)])]


@pytest.mark.parametrize("name,kind,shape", AXIOM_CASES)
def test_retraction_axioms(name, kind, shape):
    """R_x(0) = x, R_x(u) feasible, R_x(tu) = x + tu + O(t^2), and the
    projection idempotent with P_x(x) = 0 (the JAX package's bounds)."""
    d, r = shape
    m = G.get(name)
    gen = torch.Generator().manual_seed(d * 100 + r)
    for _ in range(4):
        x = m.rand(d, r, generator=gen, device="cpu")
        g = torch.randn((d, r), generator=gen)
        u = m.tangent_project(x, g)
        torch.testing.assert_close(m.tangent_project(x, u), u, rtol=0,
                                   atol=1e-5)
        assert float(m.tangent_project(x, x).abs().max()) < 1e-5
        assert float(m.check(x).max()) < 1e-5
        u = 0.2 * u / u.norm().clamp_min(1e-9)
        torch.testing.assert_close(m.retract(x, torch.zeros_like(x), kind),
                                   x, rtol=0, atol=1e-5)
        assert float(m.check(m.retract(x, u, kind)).max()) < 1e-5
        for t in (0.5, 0.25):
            resid = float((m.retract(x, t * u, kind) - (x + t * u)).norm())
            assert resid <= 8.0 * float(((t * u) ** 2).sum()) + 1e-5


@pytest.mark.parametrize("d", [1, 3, 6, 20])
def test_grassmann_square_has_no_horizontal_space(d):
    """Gr(d, d) is one point: the horizontal projection of any g at any
    basis is zero, to 1e-5 ||g||, and the distance between any two bases
    is 0 (to the rounding of angles near 0)."""
    m = G.GRASSMANN
    gen = torch.Generator().manual_seed(d)
    x, y = (m.rand(d, d, generator=gen, device="cpu") for _ in range(2))
    for scale in (1.0, 1e3):
        g = scale * torch.randn((d, d), generator=gen)
        assert float(m.tangent_project(x, g).norm()) <= 1e-5 * float(
            g.norm())
    assert float(m.dist(x, y)) < 2e-3 * d


def test_manifolds_facade():
    gen = torch.Generator().manual_seed(0)
    x = M.random_stiefel(12, 3, generator=gen, device="cpu")
    g = torch.randn((12, 3), generator=gen)
    u = M.tangent_project(x, g)
    assert bool(M.is_tangent(x, u))
    torch.testing.assert_close(M.riemannian_grad(x, g), u)
    torch.testing.assert_close(M.sym(x.T @ g), 0.5 * (x.T @ g + g.T @ x))
    for kind in ("polar", "qr", "cayley"):
        assert float(M.stiefel_error(M.retract(x, 0.1 * u, kind))) < 1e-5
    with pytest.raises(ValueError):
        M.retract(x, u, "bogus")
    assert float(M.stiefel_error(M.rgd_step(x, g, 0.1))) < 1e-5
    xs = x[None] + 0.01 * torch.randn((5, 12, 3), generator=gen)
    assert float(M.consensus_error(xs)) > 0.0
