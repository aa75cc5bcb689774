"""Micro-batching registration server (host-side serving runtime).

Port of :mod:`icp_tpu.serve`.  The card earns its throughput on batches,
but clients submit single pairs.  :class:`BatchingRegistrar` bridges the
two: requests queue on the host, one worker thread drains up to
``max_batch_size`` of them (waiting at most ``max_delay`` after the first
for stragglers), pads them into one fixed-capacity batch in numpy, copies
each stacked cloud to ``device`` in one transfer, runs the batched
``converge`` and resolves each request's future.

``capacity`` is one value or an ascending tuple of bucket capacities: each
request pads to the smallest bucket that fits it, and each bucket's batch
pads to ``max_batch_size`` with copies of its first lane, so every batch of
a bucket has one shape.  ``max_pending`` bounds the queue: beyond it
``submit`` sheds load with :class:`ServerOverloaded`.  A batch that raises
resolves each of its futures with the exception, and the worker goes on.
Transport (gRPC, HTTP) is the caller's choice.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from .cloud import PointCloud
from .driver import DriverConfig, make_converge_fn
from .geometry import RigidTransform
from .methods.base import Method


@dataclasses.dataclass
class RegistrationResult:
    rotation: np.ndarray
    translation: np.ndarray
    iterations: int
    cost: float


@dataclasses.dataclass
class _Request:
    source: np.ndarray  # (n, D)
    target: np.ndarray  # (m, D)
    guess_rotation: np.ndarray
    guess_translation: np.ndarray
    future: Future
    bucket: int = 0  # the capacity this request pads to


class ServerOverloaded(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is full."""


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


class BatchingRegistrar:
    """Thread-backed micro-batcher over the batched ``converge``.

    ``device`` is where batches run (the card unless ``"cpu"``); ``dtype``
    is the numpy dtype requests are stored and padded in, and so the
    tensors' dtype.  ``converge_fn`` (``(source, target, guess) ->
    (ConvergenceState, state)``) replaces the default
    ``make_converge_fn(method, config)``.
    """

    def __init__(
        self,
        method: Method,
        config: DriverConfig,
        capacity: int | tuple[int, ...] = 1024,
        max_batch_size: int = 256,
        max_delay: float = 0.005,
        dtype=np.float32,
        max_pending: int | None = None,
        converge_fn=None,
        device="cuda",
    ):
        self._method = method
        self._buckets = tuple(sorted({int(c) for c in np.atleast_1d(capacity)}))
        self._capacity = self._buckets[-1]
        self._max_batch = max_batch_size
        self._max_delay = max_delay
        self._dtype = dtype
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchingRegistrar: device 'cuda' needs a CUDA card "
                               "(pass device='cpu' to serve on the host)")
        self._fn = converge_fn if converge_fn is not None else make_converge_fn(method, config)
        self._queue: queue.Queue[_Request | None] = queue.Queue(
            maxsize=0 if max_pending is None else max_pending)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._lock = threading.Lock()
        self._started = False
        self._closed = False

    # -- client API --------------------------------------------------------

    def submit(self, source, target, guess: RigidTransform | None = None) -> Future:
        """Queue one pair of ``(n, D)`` arrays; returns a
        ``Future[RegistrationResult]``."""
        source = _host(source, self._dtype)
        target = _host(target, self._dtype)
        size = max(len(source), len(target))
        if size > self._capacity:
            raise ValueError(f"cloud exceeds server capacity {self._capacity}")
        bucket = next(b for b in self._buckets if size <= b)
        dim = source.shape[1]
        # A malformed request fails alone, not the batch it would join.
        if target.shape[1] != dim or dim != self._method.dim:
            raise ValueError(
                f"dimension mismatch: source {dim}D, target {target.shape[1]}D, "
                f"server method is {self._method.dim}D")
        if guess is None:
            gr = np.eye(dim, dtype=self._dtype)
            gt = np.zeros(dim, dtype=self._dtype)
        else:
            gr = _host(guess.rotation, self._dtype)
            gt = _host(guess.translation, self._dtype)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("registrar is closed")
            if not self._started:
                self._started = True
                self._worker.start()
            try:
                self._queue.put_nowait(_Request(source, target, gr, gt, fut, bucket))
            except queue.Full:
                raise ServerOverloaded(
                    f"request queue full ({self._queue.maxsize} pending)") from None
        return fut

    def register(self, source, target, guess=None, timeout=None) -> RegistrationResult:
        """Blocking :meth:`submit`."""
        return self.submit(source, target, guess).result(timeout=timeout)

    def close(self) -> None:
        """Serve what is queued, then stop the worker (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            while True:  # a full bounded queue must still accept shutdown
                try:
                    self._queue.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker ------------------------------------------------------------

    def _drain(self) -> list[_Request] | None:
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        # One deadline from the first request: stragglers do not extend it.
        deadline = time.monotonic() + self._max_delay
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post the shutdown for the outer loop
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            drained = self._drain()
            if drained is None:
                return
            # One launch per capacity bucket in the drain.
            groups: dict[int, list[_Request]] = {}
            for r in drained:
                groups.setdefault(r.bucket, []).append(r)
            for cap, batch in sorted(groups.items()):
                self._run_bucket(cap, batch)

    def _run_bucket(self, cap: int, batch: list[_Request]) -> None:
        padded = batch + [batch[0]] * (self._max_batch - len(batch))
        dim = batch[0].source.shape[1]

        def stack_clouds(key):
            pts = np.zeros((self._max_batch, cap, dim), dtype=self._dtype)
            counts = np.zeros(self._max_batch, dtype=np.int32)
            for i, r in enumerate(padded):
                arr = getattr(r, key)
                pts[i, : len(arr)] = arr
                counts[i] = len(arr)
            return PointCloud(torch.from_numpy(pts).to(self._device),
                              torch.from_numpy(counts).to(self._device))

        try:
            src = stack_clouds("source")
            tgt = stack_clouds("target")
            guess = RigidTransform(
                torch.from_numpy(np.stack([r.guess_rotation for r in padded])).to(self._device),
                torch.from_numpy(np.stack([r.guess_translation for r in padded])).to(self._device))
            result, _ = self._fn(src, tgt, guess)
            rot = result.transform.rotation.cpu().numpy()
            trans = result.transform.translation.cpu().numpy()
            iters = result.iteration_count.cpu().numpy()
            costs = result.cost.cpu().numpy()
        except Exception as exc:  # the batch's futures carry it; the worker goes on
            for r in batch:
                try:
                    r.future.set_exception(exc)
                except InvalidStateError:
                    pass  # cancelled by its client
            return
        for i, r in enumerate(batch):
            try:
                r.future.set_result(RegistrationResult(
                    rotation=rot[i], translation=trans[i], iterations=int(iters[i]),
                    cost=float(costs[i])))
            except InvalidStateError:
                pass  # cancelled by its client while running
