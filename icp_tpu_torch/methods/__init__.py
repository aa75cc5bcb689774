"""ICP methods and the string-keyed registry.

The five reference methods, as registered by ``lib/icp/icp.cpp:16-27``:
2D ``vanilla``, ``trimmed`` and ``feature_aware``; 3D ``vanilla`` and
``trimmed``.  The JAX package's net-new families (``point_to_plane``,
``robust``, ``gicp``, ``symmetric``, ``ndt``) are not ported yet.
"""

from . import feature_aware, trimmed, trimmed_3d, vanilla, vanilla_3d
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

__all__ = [
    "Matches",
    "Method",
    "from_method",
    "get_matches",
    "is_method_registered",
    "register_method",
    "registered_methods",
]
