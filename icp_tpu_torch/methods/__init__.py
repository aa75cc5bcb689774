"""ICP methods and the string-keyed registry.

Ported so far: ``trimmed`` (2D).  The other methods of
:mod:`icp_tpu.methods` are not ported yet.
"""

from . import trimmed
from .base import (
    Matches,
    Method,
    from_method,
    get_matches,
    is_method_registered,
    register_method,
    registered_methods,
)

register_method("trimmed", 2, trimmed.create)

__all__ = [
    "Matches",
    "Method",
    "from_method",
    "get_matches",
    "is_method_registered",
    "register_method",
    "registered_methods",
]
