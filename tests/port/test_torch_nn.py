"""1-NN correspondence: the port's plain version and kernel wrappers against
the JAX package's ``ops.nn``, ``fused_nearest_neighbors`` and
``nearest_neighbors_pallas`` (both Pallas kernels in interpret mode).

Indices and coordinates must be equal.  ``sq`` is compared at rtol 1e-6 in
float32 (1e-12 in float64): XLA:CPU contracts the subtract-square-add chain
into FMAs and PyTorch does not, so the last bit may differ
(``tests/test_fused_nn.py`` has the same tolerance for the same reason).  On
the card the kernel must be bit-equal to the plain version
(``test_kernel_matches_plain_on_card``, and ``chip_smoke.py``).
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.ops.fused_nn import fused_nearest_neighbors as jax_fused
from icp_tpu.ops.nn import masked_min_with_index as jax_masked_min
from icp_tpu.ops.nn import nearest_neighbors as jax_nn
from icp_tpu.ops.pallas_nn import nearest_neighbors_pallas as jax_pallas
from icp_tpu_torch._build import CSRC
from icp_tpu_torch.ops import fused_nn, nn, pallas_nn

SHAPES = [(7, 5, 2), (64, 129, 2), (953, 959, 2), (200, 300, 3), (1024, 700, 3)]


@functools.cache
def _inputs(n, m, dim, dtype=np.float32):
    rng = np.random.default_rng(n * 7919 + m * 31 + dim)
    q = rng.uniform(-50, 50, (n, dim)).astype(dtype)
    t = rng.uniform(-50, 50, (m, dim)).astype(dtype)
    mask = rng.uniform(size=m) > 0.1
    return q, t, mask


@functools.cache
def _jax_fused(n, m, dim):
    q, t, mask = _inputs(n, m, dim)
    out = jax_fused(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), return_coords=True,
                    interpret=True)
    return tuple(np.asarray(x) for x in out)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_nn(got, want_sq, want_idx, rtol=1e-6):
    np.testing.assert_array_equal(got[1].numpy(), want_idx)
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), want_sq, rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("n,m,dim", SHAPES)
def test_plain_matches_jax_nn(n, m, dim, dtype, rtol):
    q, t, mask = _inputs(n, m, dim, dtype)
    sq_j, idx_j = jax_nn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask))
    got = nn.nearest_neighbors(*_torch(q, t, mask))
    assert got[0].dtype == torch.from_numpy(q).dtype
    _assert_nn(got, np.asarray(sq_j), np.asarray(idx_j), rtol)


@pytest.mark.parametrize("n,m,dim", SHAPES)
def test_fused_matches_jax_fused_kernel(n, m, dim):
    sq_j, idx_j, coords_j = _jax_fused(n, m, dim)
    q, t, mask = _torch(*_inputs(n, m, dim))
    sq, idx, coords = fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)
    _assert_nn((sq, idx), sq_j, idx_j)
    np.testing.assert_array_equal(coords.numpy(), coords_j)  # copies of target rows
    _assert_nn(fused_nn.fused_nearest_neighbors(q, t, mask), sq_j, idx_j)


@pytest.mark.parametrize("n,m,dim", SHAPES)
def test_pallas_matches_jax_pallas_kernel(n, m, dim):
    q, t, mask = _inputs(n, m, dim)
    sq_j, idx_j = jax_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), interpret=True)
    got = pallas_nn.nearest_neighbors_pallas(*_torch(q, t, mask))
    _assert_nn(got, np.asarray(sq_j), np.asarray(idx_j))


def test_batched_matches_vmap():
    rng = np.random.default_rng(3)
    q = rng.uniform(-5, 5, (3, 50, 2)).astype(np.float32)
    t = rng.uniform(-5, 5, (3, 70, 2)).astype(np.float32)
    mask = rng.uniform(size=(3, 70)) > 0.2
    sq_j, idx_j, coords_j = jax.vmap(
        lambda a, b, mk: jax_fused(a, b, mk, return_coords=True, interpret=True)
    )(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask))
    sq_p, idx_p = jax.vmap(lambda a, b, mk: jax_pallas(a, b, mk, interpret=True))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask)
    )
    tq, tt, tm = _torch(q, t, mask)
    sq, idx, coords = fused_nn.fused_nearest_neighbors(tq, tt, tm, return_coords=True)
    _assert_nn((sq, idx), np.asarray(sq_j), np.asarray(idx_j))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(coords_j))
    _assert_nn(pallas_nn.nearest_neighbors_pallas(tq, tt, tm), np.asarray(sq_p), np.asarray(idx_p))


def test_tie_break_lowest_global_index():
    base = np.random.default_rng(4).uniform(-5, 5, (64, 2)).astype(np.float32)
    t = np.tile(base, (16, 1))  # every point 16 times
    _, idx_f = jax_fused(jnp.asarray(base), jnp.asarray(t), interpret=True)
    _, idx_p = jax_pallas(jnp.asarray(base), jnp.asarray(t), interpret=True)
    tq, tt = _torch(base, t)
    for got in (
        fused_nn.fused_nearest_neighbors(tq, tt, return_coords=True),
        pallas_nn.nearest_neighbors_pallas(tq, tt),
        nn.nearest_neighbors(tq, tt),
    ):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx_f))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx_p))
        assert int(got[1].max()) < 64  # the first copy wins


def test_all_targets_masked():
    rng = np.random.default_rng(5)
    q = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    t = rng.uniform(-1, 1, (10, 2)).astype(np.float32)
    mask = np.zeros((10,), dtype=bool)
    sq_j, idx_j, coords_j = jax_fused(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
                                      return_coords=True, interpret=True)
    sq, idx, coords = fused_nn.fused_nearest_neighbors(*_torch(q, t, mask), return_coords=True)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(sq_j))  # all +inf
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))  # all 0
    np.testing.assert_array_equal(coords.numpy(), np.asarray(coords_j))  # all 0
    assert np.isinf(sq.numpy()).all() and not idx.numpy().any() and not coords.numpy().any()


def test_plain_chunks_equal_one_pass(monkeypatch):
    rng = np.random.default_rng(6)
    q, t = _torch(rng.uniform(-5, 5, (5, 40, 2)), rng.uniform(-5, 5, (5, 60, 2)))
    mask = torch.from_numpy(rng.uniform(size=(5, 60)) > 0.3)
    whole = nn.nearest_neighbors(q, t, mask)
    # The CPU's block (CHUNK_BYTES is the card's): two lanes per chunk.
    monkeypatch.setattr(nn, "CPU_BLOCK_BYTES", 2 * 40 * 60 * 8)
    chunked = nn.nearest_neighbors(q, t, mask)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [1, 7, 40])
def test_plain_row_blocks_equal_one_pass(monkeypatch, rows):
    """A lane larger than the CPU's block runs in blocks of query rows (7
    leaves a ragged last block), with a query broadcast over the batch."""
    rng = np.random.default_rng(7)
    q, t = _torch(rng.uniform(-5, 5, (1, 40, 3)), rng.uniform(-5, 5, (3, 60, 3)))
    t[1, 5:9] = t[1, 0]  # ties across rows' blocks
    mask = torch.from_numpy(rng.uniform(size=(3, 60)) > 0.3)
    whole = nn.nearest_neighbors(q, t, mask)
    monkeypatch.setattr(nn, "CPU_BLOCK_BYTES", rows * 60 * 8)
    blocked = nn.nearest_neighbors(q, t, mask)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_masked_min_with_index_matches_jax():
    rng = np.random.default_rng(7)
    values = rng.integers(0, 4, (6, 5, 3)).astype(np.float64)  # many ties
    indices = rng.integers(0, 100, (6, 5, 3)).astype(np.int32)
    for axis in (0, 1, 2):
        mv_j, mi_j = jax_masked_min(jnp.asarray(values), jnp.asarray(indices), axis)
        mv, mi = nn.masked_min_with_index(*_torch(values, indices), axis)
        np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_j))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(mi_j))


def _bad_inputs():
    q = torch.zeros(2, 5, 2)
    t = torch.zeros(2, 6, 2)
    return {
        "dtype mix": (q, t.double(), None, TypeError),
        "int points": (q.int(), t.int(), None, TypeError),
        "D=4": (torch.zeros(2, 5, 4), torch.zeros(2, 6, 4), None, ValueError),
        "D differs": (q, torch.zeros(2, 6, 3), None, ValueError),
        "lead differs": (q, torch.zeros(3, 6, 2), None, ValueError),
        "rank differs": (q, torch.zeros(6, 2), None, ValueError),
        "mask dtype": (q, t, torch.ones(2, 6), TypeError),
        "mask shape": (q, t, torch.ones(2, 5, dtype=torch.bool), ValueError),
        "non-contiguous": (torch.zeros(2, 2, 5).transpose(1, 2), t, None, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_reject_what_the_kernel_does_not_take(case):
    q, t, mask, err = _bad_inputs()[case]
    with pytest.raises(err):
        fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)
    with pytest.raises(err):
        pallas_nn.nearest_neighbors_pallas(q, t, mask)


def test_cpu_tensors_never_launch():
    before = fused_nn.LAUNCHES
    q, t, mask = _torch(*_inputs(64, 129, 2))
    fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)
    pallas_nn.nearest_neighbors_pallas(q, t, mask)
    assert fused_nn.LAUNCHES == before
    with pytest.raises(ValueError):
        fused_nn.launch_nn_kernel(q, t, mask, return_coords=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,dim", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, n, m, dim, dtype):
    q, t, mask = (x.to(cuda_device) for x in _torch(*_inputs(n, m, dim)))
    q, t = q.to(dtype), t.to(dtype)
    before = fused_nn.LAUNCHES
    got = fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)
    got2 = pallas_nn.nearest_neighbors_pallas(q, t, mask)
    want = fused_nn.plain_fused_nearest_neighbors(q, t, mask, return_coords=True)
    torch.cuda.synchronize()
    assert fused_nn.LAUNCHES == before + 2
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for a, b in ((got, want), (got2, want[:2])):
        assert torch.equal(a[0].view(bits), b[0].view(bits))
        assert torch.equal(a[1], b[1])
    assert torch.equal(got[2], want[2])


@functools.cache
def _kernel_constants():
    """``kThreads``, ``kQ`` and ``kChunk`` as ``csrc/nn.cu`` sets them."""
    src = (CSRC / "nn.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kThreads", "kQ", "kChunk"))


def _sq_dist(q, t):
    """The kernel's per-pair arithmetic: subtract, square, add in coordinate order."""
    diff = q[..., 0] - t[..., 0]
    acc = diff * diff
    for d in range(1, q.shape[-1]):
        diff = q[..., d] - t[..., d]
        acc = acc + diff * diff
    return acc


def _emulate_nn_kernel(q, t, mask, stage_budget):
    """``csrc/nn.cu``'s schedule in PyTorch, for (B, N, D) x (B, M, D) on the CPU.

    The launch geometry and the query of each (block, thread, slot) are the
    kernel's; ``stage_budget`` (targets per block) stands for its shared-memory
    budget.  Targets are staged with masked ones and the chunk padding at +inf;
    each chunk keeps only its minimum, a strict improvement records the
    chunk, and the end of each stage rescans that chunk for its lowest index;
    coordinates are looked up once at the end.  Returns (sq, idx, coords).
    """
    threads, kq, chunk = _kernel_constants()
    b, n, dim = q.shape
    m = t.shape[1]
    lane_threads = min(threads, math.ceil(math.ceil(n / kq) / 32) * 32)
    lanes_per_block = threads // lane_threads
    blocks_per_lane = math.ceil(n / (lane_threads * kq))
    blocks = math.ceil(b / lanes_per_block) * blocks_per_lane
    stage = min(stage_budget // lanes_per_block // chunk * chunk,
                math.ceil(max(m, 1) / chunk) * chunk)

    blk = torch.arange(blocks)[:, None, None]
    thr = torch.arange(lanes_per_block * lane_threads)[None, :, None]
    slot = torch.arange(kq)[None, None, :]
    group = thr // lane_threads
    lane = ((blk // blocks_per_lane) * lanes_per_block + group).expand(-1, -1, kq).flatten()
    i = ((blk % blocks_per_lane) * lane_threads * kq + thr - group * lane_threads
         + slot * lane_threads).flatten()
    live = (lane < b) & (i < n)
    assert live.sum() == b * n and len(set(zip(lane[live].tolist(), i[live].tolist()))) == b * n
    lane, i = lane.clamp(max=b - 1), i.clamp(max=n - 1)
    qq = torch.where(live[:, None], q[lane, i], torch.zeros((), dtype=q.dtype))

    inf = torch.tensor(math.inf, dtype=q.dtype)
    valid = torch.ones((b, m), dtype=torch.bool) if mask is None else mask
    best = torch.full((len(lane),), math.inf, dtype=q.dtype)
    best_j = torch.zeros(len(lane), dtype=torch.int64)
    pend = torch.full((len(lane),), -1, dtype=torch.int64)
    for base in range(0, m, stage):
        length = min(stage, m - base)
        padded = math.ceil(length / chunk) * chunk
        tile = torch.full((b, padded, dim), math.inf, dtype=q.dtype)
        tile[:, :length] = torch.where(valid[:, base:base + length, None],
                                       t[:, base:base + length], inf)
        tile = tile[lane]
        for c0 in range(0, padded, chunk):
            cm = _sq_dist(qq[:, None], tile[:, c0:c0 + chunk]).amin(-1)
            better = cm < best
            best = torch.where(better, cm, best)
            pend = torch.where(better, c0, pend)
        rows = (pend.clamp(min=0)[:, None] + torch.arange(chunk))[..., None].expand(-1, -1, dim)
        hit = _sq_dist(qq[:, None], torch.take_along_dim(tile, rows, 1)) == best[:, None]
        found = torch.argmax(hit.to(torch.int8), dim=-1)  # the first hit
        best_j = torch.where(pend >= 0, base + pend + found, best_j)
        pend.fill_(-1)
    hit_coords = t[lane, best_j]
    coords = torch.where(torch.isinf(best)[:, None], torch.zeros((), dtype=q.dtype), hit_coords)
    out_sq = torch.empty((b, n), dtype=q.dtype)
    out_idx = torch.empty((b, n), dtype=torch.int32)
    out_coords = torch.empty((b, n, dim), dtype=q.dtype)
    out_sq[lane[live], i[live]] = best[live]
    out_idx[lane[live], i[live]] = best_j[live].to(torch.int32)
    out_coords[lane[live], i[live]] = coords[live]
    return out_sq, out_idx, out_coords


def _schedule_cases():
    """(label, query, targets, mask, stage budget) in float64; float32 is a cast."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-5, 5, (64, 2))
    masked = rng.uniform(size=(3, 203)) > 0.3
    masked[0] = False
    return {
        "ties across stages": (base[None], np.tile(base, (16, 1))[None], None, 160),
        "ties within a chunk": (base[None], np.repeat(base, 5, axis=0)[None], None, 4096),
        "all-masked lane, ragged N and M": (rng.uniform(-5, 5, (3, 37, 2)),
                                            rng.uniform(-5, 5, (3, 203, 2)), masked, 4096),
        "N = 300, three stages": (rng.uniform(-5, 5, (2, 300, 2)),
                                  rng.uniform(-5, 5, (2, 700, 2)),
                                  rng.uniform(size=(2, 700)) > 0.2, 256),
        "N = 1000, two blocks per lane, D = 3": (rng.uniform(-5, 5, (1, 1000, 3)),
                                                 rng.uniform(-5, 5, (1, 333, 3)), None, 4096),
        "lanes share a block, one stage": (rng.uniform(-5, 5, (9, 20, 2)),
                                           rng.uniform(-5, 5, (9, 50, 2)),
                                           rng.uniform(size=(9, 50)) > 0.5, 4096),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(_schedule_cases()))
def test_kernel_schedule_equals_plain(case, dtype):
    """The kernel's loop order gives the plain version's result exactly."""
    q, t, mask, budget = _schedule_cases()[case]
    q, t = (torch.from_numpy(np.ascontiguousarray(x)).to(dtype) for x in (q, t))
    mask = None if mask is None else torch.from_numpy(mask)
    got = _emulate_nn_kernel(q, t, mask, budget)
    want = fused_nn.plain_fused_nearest_neighbors(q, t, mask, return_coords=True)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got[0].view(bits), want[0].view(bits))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    if case == "ties across stages":
        assert int(got[1].max()) < 64  # the first copy wins
    if case == "ties within a chunk":
        assert not (got[1] % 5).any()  # the first of five neighbouring copies wins
