"""Geometries of the port behind the registry in ``base``: stiefel (the
paper's default), grassmann, oblique, sphere and euclidean; ``Product``
composes them over a parameter tree."""
from repro_torch.geometry import (euclidean, grassmann, oblique,  # noqa: F401
                                  stiefel)
from repro_torch.geometry.base import (REGISTRY, Manifold, as_manifold_map,
                                       check_retraction_name, get,
                                       manifold_map_from_paths, register,
                                       tangent_project_tree)
from repro_torch.geometry.euclidean import EUCLIDEAN, Euclidean
from repro_torch.geometry.grassmann import GRASSMANN, Grassmann
from repro_torch.geometry.oblique import OBLIQUE, SPHERE, Oblique, Sphere
from repro_torch.geometry.product import Product
from repro_torch.geometry.stiefel import STIEFEL, Stiefel

__all__ = ["EUCLIDEAN", "GRASSMANN", "OBLIQUE", "REGISTRY", "SPHERE",
           "STIEFEL", "Euclidean", "Grassmann", "Manifold", "Oblique",
           "Product", "Sphere", "Stiefel", "as_manifold_map",
           "check_retraction_name", "get", "manifold_map_from_paths",
           "register", "tangent_project_tree"]
