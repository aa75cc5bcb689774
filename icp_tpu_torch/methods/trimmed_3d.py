"""3D ``trimmed`` ICP: distance-gated, not overlap-rate based.

Port of :mod:`icp_tpu.methods.trimmed_3d`, after
``lib/icp/impl/trimmed_3d.cpp``.  As 3D ``vanilla``, except that only
matches with ``dist <= max_distance`` feed the fit
(``trimmed_3d.cpp:97-102``), on the double-sqrt distance, i.e. Euclidean
``d <= max_distance**2``.  Config: ``max_distance`` (default 1.0,
``trimmed_3d.cpp:27``), ``parity``, ``solver``.

The gate is a 0/1 weight vector.  An empty gate (the reference feeds 3x0
matrices to Eigen's SVD and gets NaN) gives an identity step here, the JAX
package's documented deviation.  ``mean_nn_dist`` covers all neighbours,
not only the gated ones (``trimmed_3d.cpp:115``); the driver cost is 0.0 in
parity mode, as in 3D ``vanilla``.
"""

from __future__ import annotations

from ..config import Config
from .base import Method
from .vanilla_3d import Vanilla3dState, _neighbors, advance, make_parity_cost, working_copy_init

DEFAULT_MAX_DISTANCE = 1.0  # ``trimmed_3d.cpp:27``


def create(config: Config) -> Method:
    max_distance = config.get("max_distance", DEFAULT_MAX_DISTANCE)
    parity = bool(config.get("parity", 1))
    solver = config.get("solver", "auto")

    def iterate(state: Vanilla3dState) -> Vanilla3dState:
        src = state.source
        dist, coords = _neighbors(state.c, state.target)
        weights = ((dist <= max_distance) & src.mask).to(src.dtype)
        return advance(state, dist, coords, weights, solver)

    return Method(
        name="trimmed", dim=3, init=working_copy_init, iterate=iterate,
        cost=make_parity_cost(parity),
    )
