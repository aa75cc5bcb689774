"""Traffic kind ``closed_loop``: batches of lanes of registration work, each
call starting when the last one has returned.

The traffic file's parameters:

* ``lanes``: lanes (registrations) per call;
* ``distinct_batches``: how many different batches set-up makes; the
  window calls them in turn;
* ``perturbation``: ``{"angle": a, "translation": t}``; each lane's guess is
  its pair's base pose, then a rotation by an angle in ``[-a, a]`` (about
  the z axis in 2D, about a unit axis in 3D) and a shift in ``[-t, t]`` on
  each axis;
* ``trace_calls``: how many calls of the window the traced run profiles
  (from the window's second call);
* ``sample``: how many of the window's answers the reference checks, or
  ``"all"``.

Every seed gets the same work in another order.  The lanes are one fixed
design: the configuration's pairs repeated to fill ``lanes *
distinct_batches`` lanes, the angles and shifts the midpoints of equal
strata of their ranges, the 3D axes a Fibonacci lattice on the sphere, each
list shuffled by a generator of a fixed seed (``DESIGN_SEED``) and the
lanes cut into the batches in order.  ``--seed`` (a ``torch.Generator``
seeded with it) then orders the batches and the lanes inside each batch.
A call waits for its slowest lane, so a batch made of other lanes would
take another time: with the batches fixed, two seeds differ in the order of
the same work, not in its size.

The window ends at the first call that ends ``seconds`` or more after the
first call started, once every batch has been called equally often and the
traced calls are done.
"""

import numpy as np
import torch

from harness.traffic import Batch, fibonacci_sphere, pool_tensors, rotations, strata

DESIGN_SEED = 20261018
TRACE_AT = 1  # the traced calls start at the window's second call


def make(pairs: list, capacity: int, traffic: dict, seed: int, dtype, device) -> list:
    """The traffic's ``distinct_batches`` batches for ``seed``."""
    dim = pairs[0]["source"].shape[1]
    lanes, nb = int(traffic["lanes"]), int(traffic["distinct_batches"])
    total = lanes * nb
    design = torch.Generator().manual_seed(DESIGN_SEED)

    def shuffled(values: np.ndarray) -> np.ndarray:
        return values[torch.randperm(len(values), generator=design).numpy()]

    pair = shuffled(np.arange(total) % len(pairs))
    pert = traffic["perturbation"]
    angles = shuffled(strata(total, pert["angle"]))
    axes = shuffled(fibonacci_sphere(total)) if dim == 3 else None
    shifts = np.stack([shuffled(strata(total, pert["translation"])) for _ in range(dim)], -1)
    base = np.stack([p["base"] for p in pairs])[pair]
    rot = rotations(angles, axes, dim) @ base[:, :dim, :dim]
    trans = np.einsum("lij,lj->li", rotations(angles, axes, dim), base[:, :dim, dim]) + shifts

    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    order = torch.cat([b * lanes + torch.randperm(lanes, generator=gen)
                       for b in torch.randperm(nb, generator=gen).tolist()])
    src, src_n, tgt, tgt_n = pool_tensors(pairs, capacity, dtype, device)
    pair_t = torch.tensor(pair, device=device)[order.to(device)]
    rot_t = torch.tensor(rot[order.numpy()], dtype=dtype, device=device)
    trans_t = torch.tensor(trans[order.numpy()], dtype=dtype, device=device)
    batches = []
    for b in range(nb):
        sl = slice(b * lanes, (b + 1) * lanes)
        idx = pair_t[sl]
        batches.append(Batch(idx, src[idx].contiguous(), src_n[idx].contiguous(),
                             tgt[idx].contiguous(), tgt_n[idx].contiguous(),
                             rot_t[sl].contiguous(), trans_t[sl].contiguous()))
    return batches


def window(call, batches: int, traffic: dict, seconds: float, traced=None) -> None:
    trace_calls = int(traffic["trace_calls"]) if traced is not None else 0
    first, i = None, 0
    while True:
        if trace_calls and i == TRACE_AT:
            start, end = traced(i, trace_calls)
            i += trace_calls
        else:
            start, end = call(i)
            i += 1
        first = start if first is None else first
        if end - first >= seconds and i % batches == 0 and (not trace_calls or i > TRACE_AT):
            return
