"""The reference's step of upstream's 3D ``trimmed`` method
(cornellev/icp ``lib/icp/impl/trimmed_3d.cpp``): match the moved working
copy, keep the matches with ``sqrt(sqrt(d^2)) <= max_distance``
(upstream's double square root), fit the rotation by SVD with the
reflection fix (a lane with no kept match steps by the identity), and move
the working copy by that step."""

import torch

from harness import reference as ref


def step(ar, method, lanes, rot, trans, work):
    sq, idx = ref.nearest(work, lanes.s_valid, lanes.tgt, lanes.t_valid)
    w = ((torch.sqrt(torch.sqrt(sq)) <= method.get("max_distance", 1.0))
         & lanes.s_valid).to(sq.dtype)
    fit = ref.fit_step(ar, work, ref.gather(lanes.tgt, idx), w)
    new_rot, new_trans = ref.compose(ar, fit, (rot, trans))
    return new_rot, new_trans, ref.apply(ar, *fit, work)
