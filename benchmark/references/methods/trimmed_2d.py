"""The reference's step of upstream's 2D ``trimmed`` method
(cornellev/icp ``lib/icp/impl/trimmed.cpp``): match every moved source
point to its nearest target (squared distance, ties to the lower index),
keep the ``max(1, floor(overlap_rate * n))`` cheapest matches (ties to the
lower source index), fit the rigid step in closed form on them, and move
the source by the composed pose."""

import torch

from harness import reference as ref


def trim_weights(sq, count, overlap_rate):
    """1 on the ``max(1, floor(overlap_rate * n))`` smallest ``sq`` of each
    lane (ties to the lower index; ``sq`` is +inf on padding), else 0."""
    keep = torch.clamp(torch.floor(count.double() * overlap_rate), min=1).long()
    order = torch.argsort(sq, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(sq.shape[-1], device=sq.device).expand_as(order))
    return ((rank < keep[:, None]) & torch.isfinite(sq)).to(sq.dtype)


def step(ar, method, lanes, rot, trans, work):
    sq, idx = ref.nearest(work, lanes.s_valid, lanes.tgt, lanes.t_valid)
    w = trim_weights(sq, lanes.src_n, method.get("overlap_rate", 0.9))
    fit = ref.fit_step(ar, work, ref.gather(lanes.tgt, idx), w)
    new_rot, new_trans = ref.compose(ar, fit, (rot, trans))
    return new_rot, new_trans, ref.apply(ar, new_rot, new_trans, lanes.src)
