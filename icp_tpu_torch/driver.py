"""Convergence driver.

Port of :mod:`icp_tpu.driver` (``ICPDriver<Dim>``,
``include/icp/driver.h:20-236``).  The JAX package's ``lax.while_loop``
becomes a Python loop that reads ``active.any()`` once per iteration (one
host sync each), so :func:`converge` and :func:`converge_stepped` share one
loop and differ only in the time limit, which the stepped driver checks on
the host before each step.  Every lane terminates on its own: a terminated
lane is frozen (its state, cost and iteration count stop changing), so
per-lane results equal a sequential per-pair run.

Termination criteria, in the order of ``should_terminate``
(``driver.h:154-222``):

1. ``min_iterations`` not yet reached        -> keep going (overrides all)
2. ``max_iterations`` reached                -> stop
3. ``cost < stop_cost``                      -> stop
4. ``time_limit`` exceeded (``converge_stepped`` only; all lanes at once)
5. no previous state yet                     -> keep going
6. ``|Δcost| < absolute_cost_tolerance``     -> stop
7. ``|Δcost| / cost < relative_cost_tol``    -> stop  (0/0 is NaN: false)
8. ``|angle(R_cur R_prevᵀ)| < angle_tolerance`` and
   ``|t_cur − t_prev| < translation_tolerance`` -> stop

The check runs once before the first iteration on the initial cost
(``driver.h:55-63``), so ``max_iterations=0`` performs no iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from . import geometry
from .cloud import PointCloud
from .geometry import RigidTransform
from .methods.base import Method
from .utils.profiling import nvtx_range


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Termination criteria, the setter knobs of ``ICPDriver``
    (``driver.h:80-151``).  ``None`` means the criterion is not set."""

    min_iterations: int | None = None
    max_iterations: int | None = None
    stop_cost: float | None = None
    absolute_cost_tolerance: float | None = None
    relative_cost_tolerance: float | None = None
    angle_tolerance: float | None = None  # radians; set with translation_tolerance
    translation_tolerance: float | None = None
    time_limit: float | None = None  # seconds; converge_stepped only

    def __post_init__(self):
        if (self.angle_tolerance is None) != (self.translation_tolerance is None):
            raise ValueError(
                "angle_tolerance and translation_tolerance must be set together "
                "(ICPDriver::set_transform_tolerance)"
            )
        if (
            self.min_iterations is not None
            and self.max_iterations is not None
            and self.min_iterations > self.max_iterations
        ):
            raise ValueError("min_iterations > max_iterations")


@dataclasses.dataclass(frozen=True)
class ConvergenceState:
    """Result of :func:`converge` (``ICPDriver::ConvergenceState``,
    ``driver.h:24-33``), with batch dims."""

    cost: torch.Tensor  # (...,)
    iteration_count: torch.Tensor  # (...,) int32
    transform: RigidTransform


def _should_terminate(
    config: DriverConfig,
    cost: torch.Tensor,
    iteration: torch.Tensor,
    transform: RigidTransform,
    has_last: torch.Tensor,
    last_cost: torch.Tensor,
    last_transform: RigidTransform,
) -> torch.Tensor:
    """Vectorized ``ICPDriver::should_terminate`` (``driver.h:154-222``)."""
    false = torch.zeros(cost.shape, dtype=torch.bool, device=cost.device)
    terminate = false
    if config.max_iterations is not None:
        terminate = terminate | (iteration >= config.max_iterations)
    if config.stop_cost is not None:
        terminate = terminate | (cost < config.stop_cost)

    progress = false
    if config.absolute_cost_tolerance is not None or config.relative_cost_tolerance is not None:
        delta = torch.abs(cost - last_cost)
        if config.absolute_cost_tolerance is not None:
            progress = progress | (delta < config.absolute_cost_tolerance)
        if config.relative_cost_tolerance is not None:
            progress = progress | (delta / cost < config.relative_cost_tolerance)
    if config.angle_tolerance is not None:
        rot_step = torch.matmul(transform.rotation, last_transform.rotation.transpose(-1, -2))
        angle = geometry.rotation_angle(rot_step)
        trans_delta = torch.linalg.vector_norm(
            transform.translation - last_transform.translation, dim=-1
        )
        progress = progress | (
            (torch.abs(angle) < config.angle_tolerance)
            & (trans_delta < config.translation_tolerance)
        )
    terminate = terminate | (has_last & progress)

    if config.min_iterations is not None:
        terminate = terminate & (iteration >= config.min_iterations)
    return terminate


def _freeze(active: torch.Tensor, new, old):
    """``new`` where a lane is active, else ``old``, through nested dataclasses."""
    if new is old:
        return old
    if isinstance(new, torch.Tensor):
        act = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
        return torch.where(act, new, old)
    if dataclasses.is_dataclass(new):
        return type(new)(
            **{
                f.name: _freeze(active, getattr(new, f.name), getattr(old, f.name))
                for f in dataclasses.fields(new)
            }
        )
    raise TypeError(f"cannot freeze a {type(new).__name__}")


def _loop(
    method: Method,
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    config: DriverConfig,
) -> tuple[ConvergenceState, Any]:
    """The driver loop of :func:`converge` and :func:`converge_stepped`;
    ``config.time_limit``, when set, is checked on the host before each step
    against the time since the loop began."""
    if not (source.dim == target.dim == guess.dim == method.dim):
        raise ValueError(
            f"dimension mismatch: source {source.dim}D, target {target.dim}D, "
            f"guess {guess.dim}D, method '{method.name}' is {method.dim}D"
        )
    if all(
        getattr(config, f.name) is None
        for f in dataclasses.fields(DriverConfig)
        if f.name != "min_iterations"
    ):
        raise ValueError("no termination criterion set; the loop would never end")
    start = time.monotonic()
    dev = source.points.device
    with nvtx_range("converge.init", dev):
        state = method.init(source, target, guess)
        cost = method.cost(state)
        iteration = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
        has_last = torch.zeros(cost.shape, dtype=torch.bool, device=cost.device)
        active = ~_should_terminate(
            config, cost, iteration, state.transform, has_last, cost, state.transform
        )
    while True:
        with nvtx_range("converge.sync", dev):
            if not bool(active.any()):
                break
        if config.time_limit is not None and time.monotonic() - start > config.time_limit:
            break
        with nvtx_range("converge.iterate", dev):
            last_cost, last_transform = cost, state.transform
            new_state = method.iterate(state)
            new_cost = method.cost(new_state)
            state = _freeze(active, new_state, state)
            cost = torch.where(active, new_cost, cost)
            iteration = iteration + active.to(torch.int32)
            has_last = has_last | active
            active = active & ~_should_terminate(
                config, cost, iteration, state.transform, has_last, last_cost, last_transform
            )
    return ConvergenceState(cost, iteration, state.transform), state


def converge(
    method: Method,
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    config: DriverConfig,
) -> tuple[ConvergenceState, Any]:
    """Run ICP until every lane has terminated (``ICPDriver::converge``,
    ``driver.h:51-72``, batched).  Returns ``(ConvergenceState, final method
    state)``.  ``time_limit`` is refused, as in the JAX package: use
    :func:`converge_stepped`."""
    if config.time_limit is not None:
        raise ValueError("time_limit requires the host-stepped driver (converge_stepped)")
    return _loop(method, source, target, guess, config)


def converge_stepped(
    method: Method,
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    config: DriverConfig,
) -> tuple[ConvergenceState, Any]:
    """:func:`converge` with ``time_limit`` (seconds, checked on the host
    before each step, as ``driver.h:169-174``; when it is exceeded every lane
    stops).  Per-lane freezing is :func:`converge`'s."""
    return _loop(method, source, target, guess, config)


def make_converge_fn(method: Method, config: DriverConfig):
    """``(source, target, guess) -> (ConvergenceState, state)`` with the
    method and driver config bound (the JAX package's jitted closure; here a
    plain one)."""

    def fn(source: PointCloud, target: PointCloud, guess: RigidTransform):
        return converge(method, source, target, guess, config)

    return fn
