"""Exact k-smallest selection without sorting or O(N^2) rank matrices.

Port of :mod:`icp_tpu.ops.select`.  The trim step needs 0/1 weights marking
the ``keep`` smallest match costs of each row, with ties at the cut broken
toward the lower index (the stable order of
:func:`icp_tpu_torch.methods.trimmed.stable_ranks`).  A bitwise binary search
finds the keep-th smallest value in ``nbits`` compare-and-count passes; one
cumulative sum then picks the lowest-index entries among the ties at it.
The selected set is identical to ``stable_ranks(costs) < keep``: selection
is combinatorial, not numeric.

PyTorch's unsigned integer types have thin op coverage, so the search runs
on a *signed* order-preserving key instead of the JAX package's unsigned
one: with ``i`` the float's bits viewed as a signed integer,
``key = i ^ ((i >> (nbits - 1)) & MAX)`` orders like the floats (negative
floats get their magnitude bits flipped).  The key equals the JAX package's
unsigned key with its top bit flipped, so the search makes the same
decisions.  NaN costs are unsupported; -0.0 is canonicalized to +0.0 first.
"""

from __future__ import annotations

import torch

_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def _canonical(values: torch.Tensor) -> torch.Tensor:
    """Replace -0.0 by +0.0 so bit order matches float comparison."""
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    return torch.where(values == 0, zero, values)


def order_key(values: torch.Tensor) -> torch.Tensor:
    """Signed integers with ``x < y  <=>  key(x) < key(y)`` (no -0.0, no NaN)."""
    idtype = _INT[values.dtype]
    nbits = torch.iinfo(idtype).bits
    i = values.view(idtype)
    return i ^ ((i >> (nbits - 1)) & torch.iinfo(idtype).max)


def kth_smallest(values: torch.Tensor, k) -> torch.Tensor:
    """Per-row k-th smallest (1-indexed, counting duplicates), as its
    :func:`order_key`.  ``k`` is an int or a ``(...,)`` tensor, ``k >= 1``;
    ``k > N`` gives the largest key (every entry compares below it)."""
    key = order_key(_canonical(values))
    info = torch.iinfo(key.dtype)
    k = torch.as_tensor(k, device=values.device)
    # Invariant: count(key < lo) < k.  From the top bit down, take a bit
    # when leaving it out would break the invariant; lo ends as the k-th
    # smallest key.  The top bit is the sign: its candidate is 0.
    lo = torch.full(values.shape[:-1], info.min, dtype=key.dtype, device=values.device)
    cand = lo & info.max
    lo = torch.where((key < cand[..., None]).sum(-1) >= k, lo, cand)
    for bit in range(info.bits - 2, -1, -1):
        cand = lo | (1 << bit)
        lo = torch.where((key < cand[..., None]).sum(-1) >= k, lo, cand)
    return lo


def _key_to_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`order_key` (it is its own inverse on the bits)."""
    info = torch.iinfo(key.dtype)
    return (key ^ ((key >> (info.bits - 1)) & info.max)).view(dtype)


def kth_smallest_value(values: torch.Tensor, k) -> torch.Tensor:
    """Per-row k-th smallest as a float, ``sort(v)[..., k-1]`` without the sort.

    Exact (the very bits of the element, -0.0 read as +0.0); ``k > N`` gives
    +inf.
    """
    out = _key_to_float(kth_smallest(values, k), values.dtype)
    overrun = torch.as_tensor(k, device=values.device) > values.shape[-1]
    return torch.where(overrun, torch.full_like(out, float("inf")), out)


def select_smallest_weights(costs: torch.Tensor, keep, dtype=None) -> torch.Tensor:
    """0/1 weights marking the ``keep`` smallest entries per row, stable ties.

    Equals ``stable_ranks(costs) < keep`` exactly: entries strictly below the
    keep-th smallest value are all selected; among entries equal to it, the
    lowest indices fill the remaining quota.
    """
    dtype = costs.dtype if dtype is None else dtype
    key = order_key(_canonical(costs))
    tau = kth_smallest(costs, keep)[..., None]
    keep = torch.as_tensor(keep, device=costs.device)
    less = key < tau
    need = keep[..., None] - less.sum(-1, keepdim=True)
    eq = key == tau
    before = torch.cumsum(eq, dim=-1) - eq.long()
    return (less | (eq & (before < need))).to(dtype)
