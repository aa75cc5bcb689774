"""Controls and faults: ways to break the timed path, each of which the
comparison has to catch.  Each is a ``patch`` for :func:`harness.cell.run`,
called with the :class:`~harness.system.System` before the warm-up.

Controls (the nearest precision below float32 with TF32 off):

* :func:`tf32_program`: the program with its own TF32 path switched on
  (``torch.backends.cuda.matmul.allow_tf32``, which the port turns off when
  it is imported); it changes only what the card's matrix products do.
  The control of ``trimmed3d``.  In 2D its readings cannot be told from the
  sound program's (``PERF.md``), so there
* :func:`tf32_reference`, the plain reference computed in TF32 and put in
  the program's place, is the control of ``trimmed2d``.

Faults (each planted in the program's path):

* :func:`unchanged_step`: every iteration returns its state unchanged;
* :func:`half_batch`: only the first half of each call's lanes is
  registered, the rest keep their guesses;
* :func:`altered_answer`: one lane's translation is moved by 1 mm where the
  answer is produced.

The exchange between chips cannot be left out: every cell runs on one chip.
"""

from __future__ import annotations

import dataclasses

import torch

from . import reference


def tf32_program(system) -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def tf32_reference(system) -> None:
    def call(inputs):
        source, target, guess = inputs
        dev = source.points.device
        got = reference.register_blocks(
            system.settings, "tf32", [source.points, source.count, target.points,
                                      target.count, guess.rotation, guess.translation], dev,
            system.root)
        return tuple(got[k].to(dev) for k in ("rotation", "translation", "iterations"))

    system.call = call


def unchanged_step(system) -> None:
    system.method = dataclasses.replace(system.method, iterate=lambda state: state)


def half_batch(system) -> None:
    whole = system.call

    def call(inputs):
        source, target, guess = inputs
        half = source.points.shape[0] // 2
        cut = [type(x)(*(getattr(x, f.name)[:half] for f in dataclasses.fields(x)))
               for x in inputs]
        rot, trans, it = whole(tuple(cut))
        return (torch.cat([rot, guess.rotation[half:]]),
                torch.cat([trans, guess.translation[half:]]),
                torch.cat([it, it.new_zeros(guess.translation.shape[0] - half)]))

    system.call = call


def altered_answer(system) -> None:
    whole = system.call

    def call(inputs):
        rot, trans, it = whole(inputs)
        trans = trans.clone()
        trans[0, 0] += 1e-3
        return rot, trans, it

    system.call = call
