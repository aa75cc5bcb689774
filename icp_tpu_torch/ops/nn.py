"""Exact nearest-neighbour correspondence, in plain PyTorch.

Port of :mod:`icp_tpu.ops.nn`.  These are the plain versions: the CPU path of
the 1-NN wrappers in :mod:`icp_tpu_torch.ops.fused_nn` and
:mod:`icp_tpu_torch.ops.pallas_nn`, and the oracle their CUDA kernel is held
against on the card.

Semantics, as in the JAX package: squared Euclidean distance summed per
coordinate in coordinate order (``(d0*d0) + d1*d1 ...``), masked targets at
+inf, ties to the lowest target index, and a row with no valid target gives
``(inf, 0)``.  The ``|q|^2 - 2 q.t + |t|^2`` expansion is not used: it
cancels catastrophically in float32.

PyTorch runs each elementwise step as its own kernel and materializes every
``(B, N, M)`` intermediate, so :func:`nearest_neighbors` walks the batch in
chunks that keep one intermediate under :data:`CHUNK_BYTES`; on the CPU it
walks blocks of lanes and query rows under :data:`CPU_BLOCK_BYTES`, so that
the four passes over an intermediate hit the cache (3-4x faster on an 8-core
Xeon at (1, 1024, 1024, 2) to (1, 10720, 10720, 3) in float64, the same
bits: every row's distances and minimum are its own).

Under :func:`splitting_rows` (set by :mod:`icp_tpu_torch.parallel.converge`
for a points group) the 1-NN wrappers and ``feature_aware``'s dense match
compute only this rank's block of query rows and gather the rows back; see
:func:`row_split`.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

CHUNK_BYTES = 1 << 30
CPU_BLOCK_BYTES = 1 << 22

_ROW_SPLIT = contextvars.ContextVar("icp_tpu_torch_row_split", default=None)


def row_split():
    """The query-row split in effect, or None.

    The split (an object of :mod:`icp_tpu_torch.parallel.converge`) has
    ``take(tensor, dim)``, this rank's block of ``tensor``'s rows along
    ``dim``; ``join(tensor, dim, n)``, every rank's block gathered back to
    ``n`` rows; and ``max(tensor)``, the elementwise maximum over the ranks.
    """
    return _ROW_SPLIT.get()


@contextlib.contextmanager
def splitting_rows(split):
    """Run the body with ``split`` as :func:`row_split` (None: no split)."""
    token = _ROW_SPLIT.set(split)
    try:
        yield
    finally:
        _ROW_SPLIT.reset(token)


def split_query_rows(fn, query: torch.Tensor):
    """``fn(query)`` (a tuple of outputs with the query's rows at the query's
    row axis), computed on this rank's block of rows and gathered back when
    a :func:`row_split` is in effect."""
    split = row_split()
    if split is None:
        return fn(query)
    row = query.dim() - 2
    n = query.shape[row]
    return tuple(split.join(out, row, n) for out in fn(split.take(query, row)))


def pairwise_sq_dists(query: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., N, D) x (..., M, D) -> (..., N, M)``.

    One subtract, one multiply and one add per coordinate, each a separate
    elementwise op, so nothing is contracted into a fused multiply-add; the
    multiply and the add work in place on the fresh differences.
    """
    acc = None
    for d in range(query.shape[-1]):
        diff = query[..., :, None, d] - targets[..., None, :, d]
        diff.mul_(diff)
        acc = diff if acc is None else acc.add_(diff)
    return acc


def _nearest_dense(query, targets, target_mask):
    d2 = pairwise_sq_dists(query, targets)
    if target_mask is not None:
        d2.masked_fill_(~target_mask[..., None, :], float("inf"))
    # torch.min returns the first minimal index of each row: ties go low.
    sq, idx = torch.min(d2, dim=-1)
    return sq, idx.to(torch.int32)


def nearest_neighbors(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each query among the (masked) targets.

    Shapes ``(..., N, D)``, ``(..., M, D)`` and ``(..., M)`` with leading
    dims that broadcast.  Returns ``(sq (..., N), idx (..., N) int32)``.
    """
    lead = torch.broadcast_shapes(
        query.shape[:-2],
        targets.shape[:-2],
        () if target_mask is None else target_mask.shape[:-1],
    )
    n, dim = query.shape[-2:]
    m = targets.shape[-2]
    q = query.expand(*lead, n, dim).reshape(-1, n, dim)
    t = targets.expand(*lead, m, dim).reshape(-1, m, dim)
    mk = None if target_mask is None else target_mask.expand(*lead, m).reshape(-1, m)
    batch = q.shape[0]
    block = CPU_BLOCK_BYTES if q.device.type == "cpu" else CHUNK_BYTES
    lane_bytes = max(n * m * q.element_size(), 1)
    chunk = max(1, block // lane_bytes)
    rows = n if lane_bytes <= block or q.device.type != "cpu" else max(
        1, block // max(m * q.element_size(), 1))
    if batch <= chunk and rows == n:
        sq, idx = _nearest_dense(q, t, mk)
    else:
        sq = torch.empty((batch, n), dtype=q.dtype, device=q.device)
        idx = torch.empty((batch, n), dtype=torch.int32, device=q.device)
        for b0 in range(0, batch, chunk):
            sl = slice(b0, b0 + chunk)
            for r0 in range(0, n, rows):
                rs = slice(r0, r0 + rows)
                sq[sl, rs], idx[sl, rs] = _nearest_dense(q[sl, rs], t[sl],
                                                         None if mk is None else mk[sl])
    return sq.reshape(*lead, n), idx.reshape(*lead, n)


def masked_min_with_index(
    values: torch.Tensor, indices: torch.Tensor, axis: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine ``(value, index)`` pairs along ``axis`` by minimum value, ties to
    the first entry (the building block of a sharded correspondence merge)."""
    best = torch.argmin(values, dim=axis, keepdim=True)
    min_vals = torch.take_along_dim(values, best, dim=axis)
    min_idx = torch.take_along_dim(indices, best, dim=axis)
    return min_vals.squeeze(axis), min_idx.squeeze(axis)
