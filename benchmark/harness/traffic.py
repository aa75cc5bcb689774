"""What every traffic generator shares: the batch a call takes, and the
pieces the generators build their lanes from.

A traffic file (``benchmark/traffic/<name>.json``) holds the parameters of
one mix and its ``kind``, the generator that reads it:
``benchmark/generators/<kind>.py``, a module with

* ``make(pairs, capacity, traffic, seed, dtype, device) -> list[Batch]``:
  the batches, made in set-up on the run's device from ``--seed``;
* ``window(call, batches, traffic, seconds, traced)``: the measured window.
  ``call(i)`` makes call ``i`` on batch ``i % batches``, waits for its
  answers and returns its ``(start, end)`` on the host clock;
  ``traced(i, k)``, given only in a ``--trace 1`` run, makes calls ``i`` to
  ``i + k - 1`` under the profiler and returns the first start and the last
  end.  Every call the window makes is one of these, in order from 0.

Every generator's traffic file also gives ``sample``: how many of the
window's answers the reference checks, drawn from the seed, or ``"all"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

@dataclasses.dataclass
class Batch:
    """One call's inputs, on the run's device, in the served dtype."""

    pair: torch.Tensor  # (B,) index into the configuration's pairs
    source: torch.Tensor  # (B, C, D), valid points first, zeros after
    source_count: torch.Tensor  # (B,) int32
    target: torch.Tensor
    target_count: torch.Tensor
    rotation: torch.Tensor  # (B, D, D) guess
    translation: torch.Tensor  # (B, D)


def strata(k: int, half_width: float) -> np.ndarray:
    """``k`` midpoints of equal strata of ``[-half_width, half_width]``."""
    return ((np.arange(k) + 0.5) / k * 2 - 1) * half_width


def fibonacci_sphere(k: int) -> np.ndarray:
    i = np.arange(k) + 0.5
    z = 1 - 2 * i / k
    r = np.sqrt(1 - z * z)
    phi = math.pi * (3 - math.sqrt(5)) * i
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)


def rotations(angles: np.ndarray, axes: np.ndarray | None, dim: int) -> np.ndarray:
    c, s = np.cos(angles), np.sin(angles)
    if dim == 2:
        return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    x, y, z = axes[:, 0], axes[:, 1], axes[:, 2]
    k = np.zeros((len(angles), 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 0] = -z, y, z
    k[:, 1, 2], k[:, 2, 0], k[:, 2, 1] = -x, -y, x
    eye = np.eye(3)[None]
    return eye + s[:, None, None] * k + (1 - c)[:, None, None] * (k @ k)


def pool_tensors(pairs: list[dict], capacity: int, dtype, device):
    """The pairs' clouds padded to ``capacity``: ``(P, C, D)`` and counts."""
    dim = pairs[0]["source"].shape[1]
    out = []
    for side in ("source", "target"):
        pts = np.zeros((len(pairs), capacity, dim))
        counts = np.zeros(len(pairs), dtype=np.int32)
        for i, p in enumerate(pairs):
            n = len(p[side])
            if n > capacity:
                raise ValueError(f"{p['name']}: {n} points exceed capacity {capacity}")
            pts[i, :n], counts[i] = p[side], n
        out += [torch.tensor(pts, dtype=dtype, device=device),
                torch.tensor(counts, device=device)]
    return out
