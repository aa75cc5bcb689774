"""The plain reference: ICP in plain PyTorch, lanes in blocks.

Written from the upstream sources the configurations name
(cornellev/icp ``lib/icp/impl/trimmed.cpp``, ``lib/icp/impl/trimmed_3d.cpp``
and ``include/icp/driver.h``), with nothing taken from the program under
test: no kernel, no module of the program, no value it derived.  This
module holds the arithmetic every method shares (the 1-NN search, the
weighted rigid fit, composing poses) and the driver loop; a method's step
is ``benchmark/references/methods/<method>_<D>d.py`` and an entry's
schedule of driver loops ``benchmark/references/entries/<entry>.py``, both
found by the names in the configuration's ``system`` entry.  A block of
lanes runs at once, each lane on its own clouds and guess, and each stops
on its own, as the driver does: a lane stops when it has made
``max_iterations`` steps, or when a step turned it by less than
``angle_tolerance`` and moved it by less than ``translation_tolerance``.
Each iteration computes only the lanes still active.

``precision`` picks the arithmetic: ``"float64"`` (the reference),
``"float32"``, or ``"tf32"``: float32 whose matrix products take their
operands rounded to TF32 (10 mantissa bits, as the card's tensor cores do
with TF32 allowed).  The rounding is done here, so the TF32 control reads
the same on any device and whatever kernel the library picks.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import spec

_DTYPE = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


class Arith:
    """The matrix product of one precision."""

    def __init__(self, precision: str):
        if precision not in _DTYPE:
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = _DTYPE[precision]
        self.tf32 = precision == "tf32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)


def nearest(query, q_valid, targets, t_valid, block_bytes: int = 1 << 30):
    """Squared distance and index of each query's nearest valid target.

    ``query (L, N, D)``, ``targets (L, M, D)``, masks ``(L, N)``/``(L, M)``.
    Distances are summed per coordinate; ties go to the lower index; an
    invalid query gets ``+inf``.  Works through the queries in row blocks of
    at most ``block_bytes`` of distances.
    """
    lanes, n, dim = query.shape
    m = targets.shape[1]
    rows = max(1, block_bytes // max(lanes * m * query.element_size(), 1))
    sq = torch.empty((lanes, n), dtype=query.dtype, device=query.device)
    idx = torch.empty((lanes, n), dtype=torch.long, device=query.device)
    far = ~t_valid[:, None, :]
    for r0 in range(0, n, rows):
        q = query[:, r0:r0 + rows]
        d2 = None
        for d in range(dim):
            diff = q[:, :, None, d] - targets[:, None, :, d]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        d2 = d2.masked_fill(far, math.inf)
        sq[:, r0:r0 + rows], idx[:, r0:r0 + rows] = torch.min(d2, dim=-1)
    return sq.masked_fill(~q_valid, math.inf), idx


def gather(points, idx):
    return torch.take_along_dim(points, idx[..., None].expand(*idx.shape, points.shape[-1]), 1)


def apply(ar: Arith, rot, trans, points):
    return ar.mm(points, rot.transpose(-1, -2)) + trans[:, None, :]


def compose(ar: Arith, outer, inner):
    (ro, to), (ri, ti) = outer, inner
    return ar.mm(ro, ri), ar.mm(ro, ti[..., None])[..., 0] + to


def weighted_fit(ar: Arith, a, b, w):
    """Centroids ``(ca, cb)`` and cross-covariance ``H = sum w (a-ca)(b-cb)^T``."""
    total = w.sum(-1)
    safe = torch.where(total > 0, total, torch.ones_like(total))[:, None]
    ca = ar.mm(w[:, None, :], a)[:, 0] / safe
    cb = ar.mm(w[:, None, :], b)[:, 0] / safe
    h = ar.mm(((a - ca[:, None]) * w[..., None]).transpose(1, 2), b - cb[:, None])
    return ca, cb, h, total > 0


def rotation_2d(h):
    theta = torch.atan2(h[:, 0, 1] - h[:, 1, 0], h[:, 0, 0] + h[:, 1, 1])
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def rotation_3d(h):
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(1, 2)
    flip = torch.ones_like(h[:, 0])
    flip[:, 2] = torch.sign(torch.linalg.det(v @ u.transpose(1, 2)))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    return (v * flip[:, None, :]) @ u.transpose(1, 2)


def rotation_angle(rot):
    if rot.shape[-1] == 2:
        return torch.atan2(rot[:, 1, 0], rot[:, 0, 0])
    cos = (rot.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    skew = torch.stack([rot[:, 2, 1] - rot[:, 1, 2], rot[:, 0, 2] - rot[:, 2, 0],
                        rot[:, 1, 0] - rot[:, 0, 1]], -1) / 2
    return torch.atan2(torch.linalg.vector_norm(skew, dim=-1), cos)


def fit_step(ar: Arith, a, b, w):
    ca, cb, h, any_kept = weighted_fit(ar, a, b, w)
    rot = rotation_2d(h) if a.shape[-1] == 2 else rotation_3d(h)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(rot)
    rot = torch.where(any_kept[:, None, None], rot, eye)
    trans = torch.where(any_kept[:, None], cb - ar.mm(rot, ca[..., None])[..., 0],
                        torch.zeros_like(ca))
    return rot, trans


@dataclasses.dataclass
class Lanes:
    """One level's clouds of a block of lanes: padded points, counts, masks."""

    src: torch.Tensor  # (L, N, D)
    src_n: torch.Tensor  # (L,)
    s_valid: torch.Tensor  # (L, N)
    tgt: torch.Tensor  # (L, M, D)
    t_valid: torch.Tensor  # (L, M)

    def take(self, idx: torch.Tensor) -> "Lanes":
        return Lanes(*(getattr(self, f.name)[idx] for f in dataclasses.fields(self)))


def converge(ar: Arith, step, method: dict, src, src_n, tgt, tgt_n, rot, trans, driver: dict):
    """One driver loop of ``step`` (a method's ``step``).  Returns each
    lane's pose where it stopped, after ``k`` iterations, its count ``k``,
    and its poses after ``k - 1`` and ``k + 1`` iterations (the start for
    ``k = 0``; one step past the stop), as ``{"rotation", "translation",
    "iterations", "previous", "next"}``."""
    lanes, n, _ = src.shape
    s_valid = torch.arange(n, device=src.device)[None] < src_n[:, None]
    t_valid = torch.arange(tgt.shape[1], device=src.device)[None] < tgt_n[:, None]
    data = Lanes(src, src_n, s_valid, tgt, t_valid)
    max_it = driver["max_iterations"]
    iters = torch.zeros(lanes, dtype=torch.long, device=src.device)
    active = torch.full((lanes,), max_it > 0, device=src.device)
    work = apply(ar, rot, trans, src)  # the moved source (3D: upstream's working copy)
    previous = (rot, trans)
    while bool(active.any()):
        on = active.nonzero()[:, 0]
        new_rot, new_trans, new_work = step(ar, method, data.take(on), rot[on], trans[on],
                                            work[on])
        turn = rotation_angle(ar.mm(new_rot, rot[on].transpose(1, 2))).abs()
        shift = torch.linalg.vector_norm(new_trans - trans[on], dim=-1)
        previous = (previous[0].index_copy(0, on, rot[on]),
                    previous[1].index_copy(0, on, trans[on]))
        rot = rot.index_copy(0, on, new_rot)
        trans = trans.index_copy(0, on, new_trans)
        work = work.index_copy(0, on, new_work)
        iters = iters.index_add(0, on, torch.ones_like(on))
        still = torch.zeros_like(active)
        still[on] = (turn >= driver["angle_tolerance"]) | (
            shift >= driver["translation_tolerance"])
        active = active & (iters < max_it) & still
    nxt = step(ar, method, data, rot, trans, work)[:2]
    return {"rotation": rot, "translation": trans, "iterations": iters,
            "previous": previous, "next": nxt}


DRIVER_KEYS = {"max_iterations", "angle_tolerance", "translation_tolerance"}


def register(precision: str, settings: dict, src, src_n, tgt, tgt_n, rot, trans,
             root: str = spec.ROOT) -> dict:
    """The configuration's registration of a block of lanes.

    ``settings`` is the configuration's ``"system"`` entry; the inputs are
    the lanes' padded clouds ``(L, N, D)``, counts ``(L,)`` and guesses, in
    any float dtype (cast to the precision's); the method's step and the
    entry's schedule are read from the checkout at ``root``.  Returns the
    last driver loop's :func:`converge` result.
    """
    ar = Arith(precision)
    n_max, m_max = max(int(src_n.max()), 1), max(int(tgt_n.max()), 1)
    src, tgt = src[:, :n_max].to(ar.dtype), tgt[:, :m_max].to(ar.dtype)
    rot, trans = rot.to(ar.dtype), trans.to(ar.dtype)
    method = settings["method"]
    unknown = set(settings["driver"]) - DRIVER_KEYS
    if unknown:
        raise ValueError(f"the reference has no driver setting {sorted(unknown)}")
    step = spec.module("references/methods", f"{method['name']}_{settings['dim']}d", root).step
    schedule = spec.module("references/entries", settings["entry"], root)

    def loop(s, s_n, t, t_n, r, tr, driver):
        return converge(ar, step, method, s, s_n, t, t_n, r, tr, driver)

    return schedule.register(loop, settings, src, src_n, tgt, tgt_n, rot, trans)


def register_blocks(settings: dict, precision: str, lanes: list, device,
                    root: str = spec.ROOT) -> dict:
    """:func:`register` over ``lanes``, ``[source, source_count, target,
    target_count, rotation, translation]``, in blocks of lanes on ``device``;
    returns its fields for every lane, on the host."""
    block = max(1, (1 << 19) // lanes[0].shape[1])
    parts = []
    for b0 in range(0, lanes[0].shape[0], block):
        got = register(precision, settings, *(x[b0:b0 + block].to(device) for x in lanes),
                       root=root)
        parts.append({k: (tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu())
                      for k, v in got.items()})
    return {k: (tuple(torch.cat([p[k][j] for p in parts]) for j in range(2))
                if isinstance(parts[0][k], tuple) else torch.cat([p[k] for p in parts]))
            for k in parts[0]}
