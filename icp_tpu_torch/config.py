"""Method configuration — typed key/value store.

Port of :mod:`icp_tpu.config` (pure Python, the same semantics).  Mirrors
``icp::Config`` (``include/icp/config.h:9-33``): a string-keyed map of
int/float/str parameters with per-use-site defaults, read when a method is
constructed.

Reference defaults reproduced by the methods:
  * ``overlap_rate`` = 0.9       (``lib/icp/impl/trimmed.cpp:28``,
                                  ``feature_aware.cpp:21``)
  * ``feature_weight`` = 0.7     (``feature_aware.cpp:22``)
  * ``symmetric_neighbors`` = 10 (``feature_aware.cpp:23``)
  * ``max_distance`` = 1.0       (``trimmed_3d.cpp:27``)
"""

from __future__ import annotations

from typing import Any, Mapping


class Config:
    """Immutable string-keyed parameter map with typed gets.

    Unlike the C++ version (which throws ``bad_variant_access`` on a type
    mismatch), values are coerced with the requested type on read; a value
    that cannot be coerced raises ``TypeError``.
    """

    def __init__(self, params: Mapping[str, Any] | None = None, **kwargs: Any):
        merged: dict[str, Any] = dict(params or {})
        merged.update(kwargs)
        self._params = merged

    def set(self, key: str, value: Any) -> "Config":
        """Return a new Config with ``key`` set (functional update)."""
        merged = dict(self._params)
        merged[key] = value
        return Config(merged)

    def get(self, key: str, otherwise: Any) -> Any:
        """``config.get<T>(key, default)`` — default's type guides coercion."""
        if key not in self._params:
            return otherwise
        value = self._params[key]
        if otherwise is None:
            return value
        want = type(otherwise)
        if isinstance(value, want):
            return value
        if want in (int, float) and isinstance(value, (int, float)) and not isinstance(value, bool):
            return want(value)
        raise TypeError(f"config key {key!r}: expected {want.__name__}, got {type(value).__name__}")

    def keys(self):
        return self._params.keys()

    def as_dict(self) -> dict[str, Any]:
        return dict(self._params)

    def __contains__(self, key: str) -> bool:
        return key in self._params

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self._params.items()))
        return f"Config({inner})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self._params == other._params

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._params.items())))
