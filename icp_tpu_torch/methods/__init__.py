"""ICP methods and the string-keyed registry.

The five reference methods, as registered by ``lib/icp/icp.cpp:16-27``:
2D ``vanilla``, ``trimmed`` and ``feature_aware``; 3D ``vanilla`` and
``trimmed``.  Plus the JAX package's net-new families, each in 2D and 3D:
``point_to_plane``, ``robust`` (Welsch-weighted IRLS), ``gicp``
(Generalized-ICP, plane-to-plane), ``symmetric`` (Rusinkiewicz's symmetric
objective) and ``ndt`` (Normal Distributions Transform, point- or
distribution-to-distribution).
"""

from . import (
    feature_aware,
    gicp,
    ndt,
    point_to_plane,
    robust,
    symmetric,
    trimmed,
    trimmed_3d,
    vanilla,
    vanilla_3d,
)
from .base import (
    Matches,
    Method,
    from_method,
    get_matches,
    is_method_registered,
    register_method,
    registered_methods,
)

register_method("vanilla", 2, vanilla.create)
register_method("trimmed", 2, trimmed.create)
register_method("feature_aware", 2, feature_aware.create)
register_method("vanilla", 3, vanilla_3d.create)
register_method("trimmed", 3, trimmed_3d.create)
register_method("point_to_plane", 2, lambda cfg: point_to_plane.create(cfg.set("dim", 2)))
register_method("point_to_plane", 3, lambda cfg: point_to_plane.create(cfg.set("dim", 3)))
register_method("robust", 2, lambda cfg: robust.create(cfg.set("dim", 2)))
register_method("robust", 3, lambda cfg: robust.create(cfg.set("dim", 3)))
register_method("gicp", 2, lambda cfg: gicp.create(cfg.set("dim", 2)))
register_method("gicp", 3, lambda cfg: gicp.create(cfg.set("dim", 3)))
register_method("symmetric", 2, lambda cfg: symmetric.create(cfg.set("dim", 2)))
register_method("symmetric", 3, lambda cfg: symmetric.create(cfg.set("dim", 3)))
register_method("ndt", 2, lambda cfg: ndt.create(cfg.set("dim", 2)))
register_method("ndt", 3, lambda cfg: ndt.create(cfg.set("dim", 3)))

__all__ = [
    "Matches",
    "Method",
    "from_method",
    "get_matches",
    "is_method_registered",
    "register_method",
    "registered_methods",
]
