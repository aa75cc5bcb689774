"""The system under test: the port's public entry, driven as a user drives it.

This is the only module of the benchmark that imports the program
(``icp_tpu_torch``).  A configuration's ``system`` entry says what to build
and call: ``icp_tpu_torch.from_method(method["name"], dim, Config(**rest of
method))``, ``DriverConfig(**driver)``, and the entry
``benchmark/entries/<entry>.py``, whose ``call`` gets the program's module
and returns the program's converge output.  A traced call also records
each driver loop it ran (the multiscale levels) through the functions the
entry's ``LOOPS`` names, which take and return what
``icp_tpu_torch.driver.converge`` does, without a synchronise.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from . import spec
from .record import Level


class System:
    def __init__(self, settings: dict, root: str = spec.ROOT):
        import icp_tpu_torch as icp

        self.icp = icp
        self.settings = settings
        self.root = root
        self.entry = spec.module("entries", settings["entry"], root)
        method = dict(settings["method"])
        name = method.pop("name")
        self.method = icp.from_method(name, settings["dim"], icp.Config(**method))
        self.driver = icp.DriverConfig(**settings["driver"])

    def inputs(self, batch):
        icp = self.icp
        return (icp.PointCloud(batch.source, batch.source_count),
                icp.PointCloud(batch.target, batch.target_count),
                icp.RigidTransform(batch.rotation, batch.translation))

    def call(self, inputs):
        """One call; returns ``(rotation, translation, iteration_count)``,
        possibly still being computed on the device."""
        out = self.entry.call(self.icp, self.method, self.driver, self.settings, *inputs)
        return out.transform.rotation, out.transform.translation, out.iteration_count

    @contextlib.contextmanager
    def recording_levels(self, sink: list):
        """Within the block, each driver loop appends ``(source counts,
        target counts, iteration counts, D, bytes per coordinate)`` to
        ``sink``, as device tensors (:func:`levels_of` reads them)."""
        places = []
        for name in self.entry.LOOPS:
            module, _, attr = name.partition(":")
            places.append((importlib.import_module(module), attr))
        originals = [getattr(mod, attr) for mod, attr in places]

        def wrap(loop):
            def recorded(method, source, target, guess, config):
                out = loop(method, source, target, guess, config)
                sink.append((source.count, target.count, out[0].iteration_count, source.dim,
                             source.points.element_size()))
                return out

            return recorded

        for (mod, attr), original in zip(places, originals):
            setattr(mod, attr, wrap(original))
        try:
            yield
        finally:
            for (mod, attr), original in zip(places, originals):
                setattr(mod, attr, original)


def levels_of(raw: list) -> list:
    """The recorded driver loops as :class:`Level` s (reads the device)."""
    return [Level(source_count=src.reshape(-1).tolist(), target_count=tgt.reshape(-1).tolist(),
                  iterations=it.reshape(-1).tolist(), dim=dim, dtype_bytes=size)
            for src, tgt, it, dim, size in raw]


def device_name() -> str:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
