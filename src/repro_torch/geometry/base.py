"""Manifold protocol + registry: the pluggable geometry layer of the port.

Mirrors ``src/repro/geometry/base.py``.  Every geometry works on tensors
whose *last two* dims are the matrix dims (d, r); leading dims (the node
axis) broadcast:

  * ``tangent_project(x, g)``: orthogonal projection of ambient ``g`` onto
    T_x M (``tangent_project_leaves`` for a list of leaves, and
    :func:`tangent_project_tree` for a whole tree: one call per geometry);
  * ``retract(x, u, kind=..., **kw)``: map a tangent step back onto M;
  * ``project(a)``: nearest point of M;
  * ``consensus_mean(xs)``: induced arithmetic mean over the leading node
    axis (paper Eq. 9: project the Euclidean mean);
  * ``dist(x, y)``, ``rand(d, r, generator=...)``, ``check(x)``.

Optimizer hooks: ``consensus_step`` (``alpha * P_x(mx)``), the DRGDA
x-update ``descent_update``, ``feasible_init`` and ``resolve_retraction``.

Geometries register under a name; :func:`as_manifold_map` turns a tree of
names (or instances) into Manifold instances, and
:func:`manifold_map_from_paths` builds one from the parameters' key paths.
The JAX package's legacy bool masks (``stiefel_mask``) are not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_flatten, tree_map

Tensor = torch.Tensor
Tree = Any


class Manifold:
    """Base class: shared defaults for the protocol (see module docstring)."""

    #: registry name
    name: str = "abstract"
    #: retraction kinds ``retract`` accepts
    retractions: tuple[str, ...] = ()
    #: used when ``kind`` is None or names a retraction this geometry does
    #: not implement (one config string drives every leaf)
    default_retraction: str = ""
    #: name of the fused-kernel retraction, or None.  A fused retraction
    #: takes the *ambient* update direction and projects inside the kernel.
    fused_retraction: Optional[str] = None
    #: True when points must be tall matrices (d >= r): the orthonormal-
    #: column geometries; norm-constraint geometries accept any (d, r)
    requires_tall: bool = False

    # -- protocol ----------------------------------------------------------
    def tangent_project(self, x: Tensor, g: Tensor) -> Tensor:
        raise NotImplementedError

    def tangent_project_leaves(self, xs: list[Tensor],
                               gs: list[Tensor]) -> list[Tensor]:
        """:meth:`tangent_project` of each pair of leaves; a geometry with
        a grouped kernel overrides it."""
        return [self.tangent_project(x, g) for x, g in zip(xs, gs)]

    def retract(self, x: Tensor, u: Tensor, kind: Optional[str] = None,
                **kw) -> Tensor:
        raise NotImplementedError

    def project(self, a: Tensor, method: str = "ns") -> Tensor:
        raise NotImplementedError

    def consensus_mean(self, xs: Tensor, method: str = "ns") -> Tensor:
        """IAM over the leading axis (Eq. 9): project( mean_i xs_i )."""
        return self.project(xs.mean(0), method=method)

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        raise NotImplementedError

    def rand(self, d: int, r: int, batch: tuple[int, ...] = (), *,
             generator: torch.Generator, device) -> Tensor:
        raise NotImplementedError

    def check(self, x: Tensor) -> Tensor:
        """Feasibility residual, 0 on the manifold (batched over leading
        dims)."""
        raise NotImplementedError

    # -- optimizer hooks ---------------------------------------------------
    def resolve_retraction(self, kind: Optional[str]) -> str:
        """Map a (possibly foreign) retraction name onto one this geometry
        implements."""
        if kind in self.retractions:
            return kind
        return self.default_retraction

    def consensus_step(self, x: Tensor, mx: Tensor, alpha: float) -> Tensor:
        """Tangent consensus direction of the DRGDA x-update (Alg. 1
        step 4): ``alpha * P_x([W^k x]_i)``."""
        return alpha * self.tangent_project(x, mx)

    def descent_update(self, x: Tensor, mx: Tensor, u: Tensor, *,
                       alpha: float, beta: float,
                       kind: Optional[str] = None, **kw) -> Tensor:
        """One DRGDA x-update on this leaf:
        ``R_x( alpha P_x(mx) - beta P_x(u) )``."""
        cons = self.consensus_step(x, mx, alpha)
        w = self.tangent_project(x, u)
        return self.retract(x, cons - beta * w, kind, **kw)

    def feasible_init(self, x: Tensor) -> Tensor:
        """Map raw initializer output to a feasible starting point."""
        return self.project(x)

    def __repr__(self):
        return f"{type(self).__name__}()"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY: dict[str, Manifold] = {}


def register(manifold: Manifold) -> Manifold:
    """Register a (stateless, shared) manifold instance under its name."""
    REGISTRY[manifold.name] = manifold
    return manifold


def get(name: str) -> Manifold:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown manifold {name!r}; registered: {sorted(REGISTRY)}"
        ) from None


def known_retractions() -> set[str]:
    """Union of retraction names over all registered geometries."""
    return {k for m in REGISTRY.values() for k in m.retractions}


def check_retraction_name(kind: str) -> str:
    """Raise on a retraction name NO registered geometry implements (per-leaf
    resolution falls back silently, so a typo would measure each leaf's
    default)."""
    known = known_retractions()
    if kind not in known:
        raise ValueError(
            f"unknown retraction {kind!r}; known: {sorted(known)}")
    return kind


def _as_manifold(spec) -> Manifold:
    if isinstance(spec, Manifold):
        return spec
    if isinstance(spec, str):
        return get(spec)
    raise TypeError(f"cannot interpret {spec!r} as a manifold")


def as_manifold_map(spec_tree: Tree) -> Tree:
    """Normalize a per-leaf geometry spec tree (registry names or Manifold
    instances) to Manifold instances."""
    return tree_map(_as_manifold, spec_tree,
                    is_leaf=lambda s: isinstance(s, Manifold))


def manifold_map_from_paths(params: Tree, predicate: Callable[[str], bool],
                            manifold: str | Manifold = "stiefel") -> Tree:
    """Per-leaf manifold map by matching '/'-joined key paths.

    Matched leaves get ``manifold`` (name or instance) when they are
    matrix-shaped (ndim >= 2; additionally tall, d >= r, for geometries
    with ``requires_tall``); everything else stays Euclidean.
    """
    m = _as_manifold(manifold)
    eu = get("euclidean")

    def walk(tree, path: tuple[str, ...]):
        if isinstance(tree, dict):
            return {k: walk(v, path + (_key_str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (_key_str(i),))
                              for i, v in enumerate(tree))
        ok = bool(predicate("/".join(path))) and tree.ndim >= 2 and (
            not m.requires_tall or tree.shape[-2] >= tree.shape[-1])
        return m if ok else eu

    return walk(params, ())


def _key_str(k) -> str:
    """A dict key or sequence index as one component of a key path."""
    return str(k)


def tangent_project_tree(manifold_map: Tree, x: Tree, g: Tree) -> Tree:
    """Each leaf of ``g`` projected onto the tangent space at its leaf of
    ``x`` by its geometry in ``manifold_map``; the leaves of one geometry go
    through ONE ``tangent_project_leaves`` call (on the card, one kernel
    launch for every Stiefel leaf of the tree)."""
    ms, _ = tree_flatten(manifold_map)
    xs, unflatten = tree_flatten(x)
    gs, _ = tree_flatten(g)
    groups: dict[Manifold, list[int]] = {}
    for j, m in enumerate(ms):
        groups.setdefault(m, []).append(j)
    out: list = [None] * len(xs)
    for m, idx in groups.items():
        for j, o in zip(idx, m.tangent_project_leaves([xs[j] for j in idx],
                                                      [gs[j] for j in idx])):
            out[j] = o
    return unflatten(out)
