"""``icp_tpu_torch.ops.grid_nn`` against ``icp_tpu.ops.grid_nn``.

Exact throughout: the packed cell keys (also beyond the clip range), the
sorted index, and the gated 1-NN (squared distances bit-equal, indices
equal, the overflow flag), which also equals the brute-force answer inside
the radius.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.ops import grid_nn as jgrid
from icp_tpu_torch.ops import grid_nn, nn


@pytest.mark.parametrize("scale", [1.0, 1e3, 1e12])
@pytest.mark.parametrize("dim", [2, 3])
def test_cell_keys_match_jax(dim, scale):
    """Keys and cells, including points far beyond the clip range."""
    rng = np.random.default_rng(dim)
    pts = rng.uniform(-50, 50, (300, dim)) * scale
    pts[:5] = [[-0.5] * dim, [0.0] * dim, [0.49999] * dim, [-1e-300] * dim, [7.25] * dim]
    for cell in (0.5, 0.37):
        key, cells = grid_nn._cell_keys(torch.from_numpy(pts), cell, dim)
        jkey, jcells = jax.jit(jgrid._cell_keys, static_argnums=2)(jnp.asarray(pts), cell, dim)
        assert key.dtype == torch.int32
        np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
        np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))


def _clouds(dim, n, m, seed, dup=False):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-6, 6, (n, dim))
    t = rng.uniform(-6, 6, (m, dim))
    if dup:  # exact duplicates: ties to the lowest index
        t[m // 2:] = t[: m - m // 2]
        q[: n // 2] = t[: n // 2]
    mask = rng.uniform(size=m) > 0.3
    return q, t, mask


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_grid_nn_matches_jax_and_brute_force(dim, dup):
    q, t, mask = _clouds(dim, 150, 400, dim + 2 * dup, dup)
    cell, cap = 1.5, 48
    grid = grid_nn.build_grid(torch.from_numpy(t), torch.from_numpy(mask), cell)
    jg = jax.jit(jgrid.build_grid)(jnp.asarray(t), jnp.asarray(mask), cell)
    for got, want in zip(grid, jg):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sq, idx, over = grid_nn.grid_nearest_neighbors(torch.from_numpy(q), grid, cap)
    # Eagerly: under jit, XLA contracts the distances into FMAs.
    jsq, jidx, jover = jgrid.grid_nearest_neighbors(jnp.asarray(q), jg, cap)
    assert bool(over) == bool(jover) is False
    np.testing.assert_array_equal(sq.numpy().view(np.int64), np.asarray(jsq).view(np.int64))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    bsq, bidx = nn.nearest_neighbors(torch.from_numpy(q), torch.from_numpy(t),
                                     torch.from_numpy(mask))
    inside = bsq <= cell * cell
    assert torch.equal(sq[inside], bsq[inside]) and torch.equal(idx[inside], bidx[inside])
    assert torch.isinf(sq[~inside]).all() and (idx[~inside] == 0).all()


def test_grid_nn_overflow_flag():
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 0.4, (100, 2))  # one cell holds all of them
    q = rng.uniform(0, 0.4, (10, 2))
    grid = grid_nn.build_grid(torch.from_numpy(t), None, 0.5)
    _, _, over = grid_nn.grid_nearest_neighbors(torch.from_numpy(q), grid, 64)
    _, _, jover = jax.jit(jgrid.grid_nearest_neighbors, static_argnums=2)(
        jnp.asarray(q), jax.jit(jgrid.build_grid, static_argnums=1)(jnp.asarray(t), None, 0.5), 64)
    assert bool(over) and bool(jover)
