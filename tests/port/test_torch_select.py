"""Trim selection: the port's radix k-smallest search against the JAX
package's, on the same costs.  Selection is combinatorial, so every
comparison is exact: ties, +-inf, -0.0, keep > n and empty rows, in float32
and float64.

Each JAX call compiles once per shape, so the cases are padded to one width
with +inf on the right and run through each implementation in one call per
dtype.  The padding cannot change the selection of the real entries: +inf is
the largest value and the padding sits at the highest indices, so it ranks
after every real entry.  Each case is then checked on its own rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.methods.trimmed import stable_ranks as jax_stable_ranks
from icp_tpu.methods.trimmed import trim_weights as jax_trim_weights
from icp_tpu.ops.select import kth_smallest_value as jax_kth_value
from icp_tpu.ops.select import select_smallest_weights as jax_select
from icp_tpu_torch.methods import trimmed
from icp_tpu_torch.ops import select

DTYPES = [np.float32, np.float64]
WIDTH = 260


def _cases(dtype):
    """name -> (costs (R, N), keeps to try (each a per-row int array))."""
    rng = np.random.default_rng(0)
    out = {}
    for n in (1, 7, 64, 257):
        costs = rng.uniform(0, 100, (4, n))
        out[f"unique n={n}"] = (costs, [rng.integers(1, n + 1, (4,)), np.full(4, n)])
    ties = rng.integers(0, 5, (8, 96)) * 0.25  # long runs of duplicates at the cut
    out["massive ties"] = (ties, [np.full(8, k) for k in (1, 2, 47, 48, 49, 95, 96)])
    pad = np.array([[3.0, np.inf, 1.0, np.inf, 2.0, np.inf]])
    out["+inf padding"] = (pad, [np.array([k]) for k in range(1, 7)])
    signed = np.array([[-np.inf, 3.0, np.inf, -2.5, -np.inf, 0.5, -2.5]])
    out["+-inf and negatives"] = (signed, [np.array([k]) for k in range(1, 8)])
    out["all +inf"] = (np.full((2, 5), np.inf), [np.array([1, 3]), np.array([5, 5])])
    zeros = np.array([[0.0, -0.0, 0.0, 1.0, -0.0]])
    out["zeros and -0.0"] = (zeros, [np.array([k]) for k in range(1, 6)])
    neg = rng.uniform(-50, 50, (3, 33))
    neg[0, :7] = -7.25
    out["negative costs"] = (neg, [np.full(3, k) for k in (1, 5, 17, 33)])
    out["keep > n"] = (np.array([[1.0, 2.0], [2.0, 2.0]]), [np.array([5, 3]), np.full(2, 999)])
    return {k: (v.astype(dtype), keeps) for k, (v, keeps) in out.items()}


CASE_NAMES = sorted(_cases(np.float32))


def _pad(costs):
    out = np.full((costs.shape[0], WIDTH), np.inf, dtype=costs.dtype)
    out[:, : costs.shape[1]] = costs
    return out


@functools.cache
def _select_table(dtype):
    """Every case's rows, once per keep, padded: (costs, keep, jax, port, spans)."""
    rows, keeps, spans = [], [], {}
    for name, (costs, case_keeps) in _cases(dtype).items():
        start = sum(len(r) for r in rows)
        for keep in case_keeps:
            rows.append(_pad(costs))
            keeps.append(keep)
        spans[name] = slice(start, start + len(case_keeps) * len(costs))
    costs, keep = np.concatenate(rows), np.concatenate(keeps)
    want = np.asarray(jax_select(jnp.asarray(costs), jnp.asarray(keep), jnp.dtype(dtype)))
    got = select.select_smallest_weights(torch.from_numpy(costs), torch.from_numpy(keep))
    assert got.dtype == torch.from_numpy(costs).dtype
    return costs, keep, want, got.numpy(), spans


@functools.cache
def _kth_table(dtype):
    """Every case's rows, once per k (1, 2, n/2, n, beyond the width), padded."""
    rows, ks, spans = [], [], {}
    for name, (costs, _) in _cases(dtype).items():
        n = costs.shape[1]
        start = sum(len(r) for r in rows)
        for k in sorted({1, 2, (n + 1) // 2, n, WIDTH + 3}):
            rows.append(_pad(costs))
            ks.append(np.full(len(costs), k))
        spans[name] = slice(start, sum(len(r) for r in rows))
    costs, k = np.concatenate(rows), np.concatenate(ks)
    want = np.asarray(jax_kth_value(jnp.asarray(costs), jnp.asarray(k)))
    got = select.kth_smallest_value(torch.from_numpy(costs), torch.from_numpy(k))
    return costs, k, want, got.numpy(), spans


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_select_smallest_weights_equals_jax(case, dtype):
    costs, keep, want, got, spans = _select_table(dtype)
    rows = spans[case]
    np.testing.assert_array_equal(got[rows], want[rows])
    # The real entries' selection is the stable-rank oracle's, unpadded.
    n = _cases(dtype)[case][0].shape[1]
    ranks = trimmed.stable_ranks(torch.from_numpy(costs[rows, :n])).numpy()
    np.testing.assert_array_equal(got[rows, :n], (ranks < keep[rows, None]).astype(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_kth_smallest_value_equals_jax(case, dtype):
    costs, k, want, got, spans = _kth_table(dtype)
    rows = spans[case]
    np.testing.assert_array_equal(got[rows], want[rows])
    # sort(v)[k-1] with -0.0 read as +0.0; +inf past the width.
    srt = np.sort(costs[rows] + 0.0, axis=-1)
    kk = k[rows]
    inside = kk <= WIDTH
    np.testing.assert_array_equal(got[rows][inside], srt[inside, kk[inside] - 1])
    assert np.isposinf(got[rows][~inside]).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_rows_equal_jax(dtype):
    costs = np.zeros((2, 0), dtype=dtype)
    keep = np.array([1, 3])
    select_j = jax.jit(jax_select, static_argnums=2)
    want = np.asarray(select_j(jnp.asarray(costs), jnp.asarray(keep), jnp.dtype(dtype)))
    got = select.select_smallest_weights(torch.from_numpy(costs), torch.from_numpy(keep))
    assert got.shape == (2, 0) == want.shape


@pytest.mark.parametrize("dtype", DTYPES)
def test_stable_ranks_equal_jax(dtype):
    costs = (np.random.default_rng(1).integers(0, 6, (5, 300)) * 0.5).astype(dtype)
    costs[:, -20:] = np.inf
    want = np.asarray(jax_stable_ranks(jnp.asarray(costs)))
    np.testing.assert_array_equal(trimmed.stable_ranks(torch.from_numpy(costs)).numpy(), want)


def test_stable_ranks_argsort_branch():
    costs = np.random.default_rng(2).integers(0, 50, (2, 5000)).astype(np.float32)
    ranks = trimmed.stable_ranks(torch.from_numpy(costs)).numpy()
    order = np.argsort(costs, axis=-1, kind="stable")
    want = np.empty_like(order)
    np.put_along_axis(want, order, np.arange(5000)[None].repeat(2, 0), -1)
    np.testing.assert_array_equal(ranks, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("selector", ["radix", "rank"])
def test_trim_weights_equal_jax(dtype, selector):
    rng = np.random.default_rng(3)
    costs = rng.uniform(0, 4, (6, 128)).astype(dtype)
    costs[:, 100:] = np.inf  # padded slots
    costs[0, :40] = 1.0  # ties at the cut
    count = np.array([100, 100, 0, 1, 57, 100], dtype=np.int32)
    want = jax_trim_weights(jnp.asarray(costs), jnp.asarray(count), 0.9, jnp.dtype(dtype),
                            selector=selector)
    got = trimmed.trim_weights(torch.from_numpy(costs), torch.from_numpy(count), 0.9,
                               torch.from_numpy(costs).dtype, selector=selector)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trim_weights_rejects_unknown_selector():
    with pytest.raises(ValueError):
        trimmed.trim_weights(torch.zeros(1, 3), torch.tensor([3]), 0.9, torch.float32, "heap")


@pytest.mark.parametrize("dtype", DTYPES)
def test_order_key_orders_like_floats(dtype):
    vals = np.array([-np.inf, -3.5, -1e-30, 0.0, 1e-30, 2.0, np.finfo(dtype).max, np.inf])
    keys = select.order_key(torch.from_numpy(vals.astype(dtype))).numpy()
    assert (np.diff(keys) > 0).all()
