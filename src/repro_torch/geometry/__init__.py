"""Geometries of the port (Stiefel, Euclidean) behind the registry in ``base``."""
from repro_torch.geometry import euclidean, stiefel  # noqa: F401  (register)
from repro_torch.geometry.base import (REGISTRY, Manifold, as_manifold_map,
                                       check_retraction_name, get, register,
                                       tangent_project_tree)

__all__ = ["REGISTRY", "Manifold", "as_manifold_map", "check_retraction_name",
           "get", "register", "tangent_project_tree"]
